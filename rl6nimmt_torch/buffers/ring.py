"""Fixed-capacity device ring replay buffer (port of ``buffers/ring.py``).

Unlike the JAX version, writes are **in place**: :func:`circular_write`
mutates the storage tensor with ``index_copy_`` and the ``*_add_batch``
functions return a new :class:`RingState` that shares (and has mutated) the
old one's storage.  Callers that need the old contents must clone first.
``ptr`` and ``size`` are host ints: they advance by
the known batch size, so keeping them on the host costs no device sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..utils.device import resolve_device


def circular_write(buf: torch.Tensor, items: torch.Tensor, ptr: int, axis: int = 0) -> torch.Tensor:
    """Write ``items`` at slots ``(ptr + arange(n)) % cap`` along ``axis``, IN PLACE.

    Items are cast to the buffer's dtype (the JAX version's contract).
    Returns ``buf``.
    """
    axis = axis % buf.ndim
    n, cap = items.shape[axis], buf.shape[axis]
    if n > cap:
        raise ValueError(f"batch of {n} exceeds capacity {cap}")
    idx = (int(ptr) + torch.arange(n, device=buf.device)) % cap
    return buf.index_copy_(axis, idx, items.to(buf.dtype))


@dataclass
class RingState:
    """storage: dict of ``[capacity, ...]`` tensors; ptr/size: host ints."""

    storage: Dict[str, torch.Tensor]
    ptr: int
    size: int

    @property
    def capacity(self) -> int:
        return next(iter(self.storage.values())).shape[0]


def ring_init(capacity: int, example: Dict[str, torch.Tensor], device="cuda") -> RingState:
    """Allocate a buffer shaped after one example transition."""
    device = resolve_device(device)
    storage = {k: torch.zeros((capacity,) + tuple(v.shape), dtype=v.dtype, device=device)
               for k, v in example.items()}
    return RingState(storage, 0, 0)


def ring_capacity(state: RingState) -> int:
    return state.capacity


def _one(items, storage: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A single transition as a batch of one on the buffer's device."""
    return {k: torch.as_tensor(items[k], device=buf.device)[None] for k, buf in storage.items()}


def ring_add(state: RingState, item) -> RingState:
    """Store one transition at the write pointer (wrapping overwrite, in place)."""
    return ring_add_batch(state, _one(item, state.storage))


def ring_add_batch(state: RingState, items: Dict[str, torch.Tensor]) -> RingState:
    """Store a leading-axis batch (wrapping overwrite, in place)."""
    n = next(iter(items.values())).shape[0]
    cap = state.capacity
    if n > cap:
        raise ValueError(f"batch of {n} transitions exceeds buffer capacity {cap}")
    for k, buf in state.storage.items():
        circular_write(buf, items[k], state.ptr)
    return RingState(state.storage, (state.ptr + n) % cap, min(state.size + n, cap))


def ring_clear(state: RingState) -> RingState:
    """Empty the ring (the storage keeps its contents, as in JAX)."""
    return RingState(state.storage, 0, 0)


def ring_sample(state: RingState, u: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Uniform sample (with replacement) from injected uniforms ``u[n]``.

    Index ``floor(u * size)``; the JAX version drew ``randint`` from a key,
    which cannot be replayed here (see PARITY_TORCH.md).
    """
    size = max(state.size, 1)
    idx = torch.clamp(torch.floor(u.double() * size).long(), max=size - 1)
    return idx, {k: buf[idx] for k, buf in state.storage.items()}
