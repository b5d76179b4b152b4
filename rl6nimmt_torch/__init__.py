"""rl6nimmt_torch: the PyTorch/CUDA port of ``rl6nimmt_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(``engine``, ``nets``, ``buffers``, ``agents``, ``runtime``, ``ops``,
``utils``) and never imports JAX or ``rl6nimmt_tpu``.  Every TPU Pallas kernel
on the ported path is a hand-written CUDA C++ kernel for ``sm_90a`` under
``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``) and bound with
``ctypes``; each has a plain PyTorch twin in the same module that runs on CPU
tensors.

Entry points take ``device=`` (default ``"cuda"``) and raise when no card is
present unless the caller passes ``device="cpu"``.
"""

from .engine import EnvConfig, EnvState, InvalidMoveException, SechsNimmtEnv
from .runtime import GameSession
from .tournament import Tournament

__version__ = "0.1.0"

__all__ = [
    "EnvConfig",
    "EnvState",
    "GameSession",
    "InvalidMoveException",
    "SechsNimmtEnv",
    "Tournament",
    "__version__",
]
