"""Discounted returns (port of ``utils/returns.py``)."""

from __future__ import annotations

import torch


def discounted_returns(rewards: torch.Tensor, gamma: float) -> torch.Tensor:
    """``G_t = r_t + gamma * G_{t+1}`` along the leading (time) axis.

    A reverse loop over the T steps; trailing axes are batch axes (the JAX
    version scanned one ``[T]`` episode and was vmapped).
    """
    out = torch.empty_like(rewards)
    g = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        g = rewards[t] + gamma * g
        out[t] = g
    return out
