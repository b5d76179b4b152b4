"""Index helpers (counterparts of ``rl6nimmt_tpu/utils/tpu_ops.py``).

On the TPU these were one-hot sums because gathers lowered to a slow path;
on the GPU a gather is cheap, so only the semantics are kept.
"""

from __future__ import annotations

import torch


def uniform_index(u: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``floor(u * count)`` clamped to ``count - 1`` (0 where ``count == 0``).

    ``u`` holds one uniform in ``[0, 1)`` per element (injected, so tests can
    hand both frameworks the same draws).  Computed in float32 like the JAX
    version, so equal uniforms give equal indices.
    """
    r = torch.floor(u.float() * count.float()).long()
    return torch.minimum(r, torch.clamp(count.long() - 1, min=0))


def onehot_select(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` along the last axis (``take_along_axis`` semantics)."""
    return torch.gather(x, -1, idx.long().unsqueeze(-1)).squeeze(-1)
