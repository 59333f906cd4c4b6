"""Config access (counterpart of ``recboard_tpu/parser.py``).

Serving reads a finished run's resolved ``config.yaml`` snapshot; this
module keeps the attribute-style ``Config`` it is loaded into and the
checkpoint file names that ``recboard_tpu``'s ``Parser.compile`` writes
into every snapshot. The CLI/YAML ``Parser`` itself arrives with the
training slice.
"""

from __future__ import annotations

from typing import Any

__all__ = ["Config", "BEST_FILENAME", "SAVED_FILENAME"]

# the params pickles a run leaves under CHECKPOINT_PATH (pickles despite
# the suffix; recboard_tpu/parser.py sets the same names)
SAVED_FILENAME = "model.safetensors"
BEST_FILENAME = "best.safetensors"


class Config(dict):
    """Attribute-accessible config: ``cfg.x`` and ``cfg.get(k, default)``."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        del self[key]
