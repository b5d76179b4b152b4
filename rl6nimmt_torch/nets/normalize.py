"""Per-segment affine normalization of the observation vector (port of ``nets/normalize.py``).

Each block of the (optionally action-prefixed) state vector is mapped to
[-1, 1] with the reference's hardcoded segment ranges:

| block                | length | min | max       |
|----------------------|--------|-----|-----------|
| action (optional)    | 1      | 0   | cards - 1 |
| own hand             | 10     | 0   | cards - 1 |
| number of players    | 1      | 0   | 6         |
| cards per row        | rows   | 1   | 5         |
| highest card per row | rows   | 0   | cards - 1 |
| points per row       | rows   | 1   | 10        |
| raw board grid       | rest   | 0   | cards - 1 |

The per-feature scale and shift are float32 NumPy constants computed once per
layout (the JAX module's ``_scale_shift``, copied), so the normalization is
``x * scale + shift`` with the same constants in both packages.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _scale_shift(length: int, action: bool, cards: int, rows: int, hand: int, summaries: bool):
    """Precompute per-feature (scale, shift) mapping x -> -1 + 2*(x-min)/(max-min)."""
    mins = np.empty(length, dtype=np.float32)
    maxs = np.empty(length, dtype=np.float32)
    pos = 0

    def block(n, lo, hi):
        nonlocal pos
        mins[pos : pos + n] = lo
        maxs[pos : pos + n] = hi
        pos += n

    if action:
        block(1, 0, cards - 1)
    block(hand, 0, cards - 1)
    block(1, 0, 6)
    if summaries:
        block(rows, 1, 5)
        block(rows, 0, cards - 1)
        block(rows, 1, 10)
    block(length - pos, 0, cards - 1)

    scale = 2.0 / (maxs - mins)
    shift = -1.0 - mins * scale
    return scale, shift


@functools.lru_cache(maxsize=None)
def _scale_shift_tensors(length, action, cards, rows, hand, summaries, device: torch.device):
    """The constants of :func:`_scale_shift` as tensors on ``device`` (copied there once)."""
    scale, shift = _scale_shift(length, action, cards, rows, hand, summaries)
    return torch.from_numpy(scale).to(device), torch.from_numpy(shift).to(device)


def normalize_state(
    x: torch.Tensor,
    action: bool = False,
    cards: int = 104,
    rows: int = 4,
    hand: int = 10,
    summaries: bool = True,
) -> torch.Tensor:
    """Normalize ``[..., state_length(+1)]`` float32 observations to [-1, 1] per block."""
    scale, shift = _scale_shift_tensors(int(x.shape[-1]), action, cards, rows, hand, summaries, x.device)
    return x * scale + shift
