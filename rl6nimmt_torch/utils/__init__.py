"""Device resolution, index helpers, returns and checkpoints (port of
``rl6nimmt_tpu.utils``)."""

from .checkpoint import (
    load_checkpoint,
    load_params,
    load_params_orbax,
    save_checkpoint,
    save_params,
    save_params_orbax,
)
from .returns import discounted_returns
from .various import iter_flatten

__all__ = [
    "discounted_returns",
    "iter_flatten",
    "load_checkpoint",
    "load_params_orbax",
    "save_params_orbax",
    "load_params",
    "save_checkpoint",
    "save_params",
]
