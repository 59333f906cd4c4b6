"""Host data layer: tagged fields, datasets, sampling pipes, builders."""

from . import datasets, fields, pipes, preprocessing, synthetic, tags  # noqa: F401
