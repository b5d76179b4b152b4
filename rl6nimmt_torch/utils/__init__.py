"""Device resolution, index helpers, returns and checkpoints (port of
``rl6nimmt_tpu.utils``; the npz/Orbax params files and ``iter_flatten`` are
ROADMAP queue 1 item 12)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .returns import discounted_returns

__all__ = [
    "discounted_returns",
    "load_checkpoint",
    "save_checkpoint",
]
