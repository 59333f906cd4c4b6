"""Models: base contracts, shared blocks, the zoo and the flax→torch
weight transplant."""

from . import base, convert, modules, zoo  # noqa: F401
