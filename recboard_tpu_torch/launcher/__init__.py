"""Training and evaluation engine (counterpart of ``recboard_tpu/launcher``)."""

from .coach import Coach, EarlyStopError

__all__ = ["Coach", "EarlyStopError"]
