"""Fixed-shape sequence replay buffer, ACER's rollout memory (port of ``buffers/sequence.py``).

Steps accumulate into a current sequence; ``seq_flush`` pushes the whole
sequence into long-term memory as one record.  Both live in fixed-shape
tensors:

* long-term storage has leaves ``[capacity, max_len, ...]`` with a per-slot
  ``seq_len`` (ragged sequences are length-masked, never re-shaped);
* the current sequence is a ``[max_len, ...]`` scratch dict plus a counter;
* the reference's per-step ``first`` flag needs no storage: within a fixed
  layout it is simply ``position == 0``.

As the port's ring and PER buffers, every write is **in place** and the
functions return the same :class:`SeqState`, whose ``ptr``, ``size`` and
``cur_len`` are host ints.  :func:`seq_sample` takes injected indices or a
``torch.Generator`` (the JAX version drew ``randint`` from a key).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..utils.device import resolve_device
from .ring import circular_write


@dataclass
class SeqState:
    storage: Dict[str, torch.Tensor]   # leaves [capacity, max_len, ...]
    seq_len: torch.Tensor              # int32[capacity]
    ptr: int
    size: int
    current: Dict[str, torch.Tensor]   # leaves [max_len, ...]
    cur_len: int

    @property
    def capacity(self) -> int:
        return self.seq_len.shape[0]


def seq_init(capacity: int, max_len: int, example: Dict[str, torch.Tensor], device="cuda") -> SeqState:
    """Allocate a buffer of ``capacity`` sequences of up to ``max_len`` steps
    shaped after one example step."""
    dev = resolve_device(device)

    def zeros(lead):
        return {k: torch.zeros(lead + tuple(v.shape), dtype=v.dtype, device=dev) for k, v in example.items()}

    return SeqState(storage=zeros((capacity, max_len)), seq_len=torch.zeros(capacity, dtype=torch.int32, device=dev),
                    ptr=0, size=0, current=zeros((max_len,)), cur_len=0)


def seq_capacity(state: SeqState) -> int:
    return state.capacity


def seq_store(state: SeqState, item: Dict[str, torch.Tensor]) -> SeqState:
    """Append one step to the current (not yet flushed) sequence."""
    max_len = next(iter(state.current.values())).shape[0]
    if state.cur_len >= max_len:   # JAX's out-of-range .at[].set drops the step silently
        raise ValueError(f"the current sequence is full ({max_len} steps): flush it first")
    for k, buf in state.current.items():
        buf[state.cur_len] = item[k]
    state.cur_len += 1
    return state


def seq_flush(state: SeqState) -> SeqState:
    """Commit the current sequence to long-term memory and reset it."""
    for k, buf in state.storage.items():
        buf[state.ptr] = state.current[k]
        state.current[k].zero_()
    state.seq_len[state.ptr] = state.cur_len
    state.ptr = (state.ptr + 1) % state.capacity
    state.size = min(state.size + 1, state.capacity)
    state.cur_len = 0
    return state


def seq_store_batch(state: SeqState, seqs: Dict[str, torch.Tensor], lengths: torch.Tensor) -> SeqState:
    """Flush ``B`` complete sequences at once (the vectorized trainer's path).

    ``seqs`` leaves are ``[B, max_len, ...]``; ``lengths`` is ``int[B]``.
    Writes occupy slots ``ptr..ptr+B-1`` modulo capacity; B must not exceed
    the capacity (duplicate write positions would corrupt slots silently).
    """
    cap, B = state.capacity, lengths.shape[0]
    if B > cap:
        raise ValueError(f"batch of {B} sequences exceeds buffer capacity {cap}")
    for k, buf in state.storage.items():
        circular_write(buf, seqs[k], state.ptr)
    circular_write(state.seq_len, lengths, state.ptr)
    state.ptr = (state.ptr + B) % cap
    state.size = min(state.size + B, cap)
    return state


def seq_sample(state: SeqState, n: int, idx: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """Uniform sample of ``n`` sequences with replacement -> ``(indices, batch, lengths)``.

    The indices are ``idx`` when given (in ``[0, max(size, 1))``), else drawn
    from ``generator`` on the buffer's device.
    """
    dev = state.seq_len.device
    if idx is None:
        idx = torch.randint(0, max(state.size, 1), (n,), generator=generator, device=dev)
    elif idx.shape != (n,) or (n and not 0 <= int(idx.min()) <= int(idx.max()) < max(state.size, 1)):
        raise ValueError(f"expected {n} indices in [0, {max(state.size, 1)}), got {idx.tolist()}")
    idx = idx.to(dev, torch.int64)
    return idx, {k: buf[idx] for k, buf in state.storage.items()}, state.seq_len[idx]


def seq_latest(state: SeqState) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The most recently flushed sequence (ACER's on-policy rollout)."""
    last = (state.ptr - 1) % state.capacity
    return {k: buf[last] for k, buf in state.storage.items()}, state.seq_len[last]
