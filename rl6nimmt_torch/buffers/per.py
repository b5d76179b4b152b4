"""Prioritized experience replay on the device (port of ``buffers/per.py``).

Same constants and math as the JAX version (reference
replay_buffer.py:15-203): max-priority inserts, stratified sampling resolved
by the two-level block prefix sum of :func:`_stratified_indices`, IS weights
``(p / min_p) ** -beta`` with beta annealed by +0.001 per sample, and
priority updates ``min(|err| + eps, 1) ** alpha``.

Differences from the JAX version, all in ``PARITY_TORCH.md``:

* storage and priorities are updated **in place** (``index_copy_``); the
  functions still return a new :class:`PERState` carrying the advanced
  host-side ``ptr``/``size`` and the device-side ``beta``;
* the JAX package's storage layouts: row-major (:func:`per_init`, slot
  axis first), feature-major (:func:`per_init_fm`, slot axis last; pass
  ``slot_axis=-1`` to :func:`per_add_batch` and :func:`per_sample`), the
  block-aligned twins of both (:func:`per_init_aligned`,
  :func:`per_init_aligned_fm`, filled by :func:`per_add_batch_aligned`: one
  slice write a cycle, never a wrap) and the direct-insert planes of
  :func:`per_init_kd` (slot axis last) that K5 writes itself, with
  :func:`per_mark_batch` doing the bookkeeping;
* :func:`per_sample` takes its uniforms ``u[n]`` as an argument (injected
  randomness), instead of a key;
* :func:`per_update` resolves duplicate indices explicitly: the LAST
  occurrence wins, which is what JAX's ``.at[idx].set`` does on the CPU, and
  the write itself only ever sees unique indices, so it is deterministic on
  the GPU too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..utils.device import resolve_device
from .ring import _one, circular_write

ABS_ERROR_UPPER = 1.0
EPSILON = 0.01
ALPHA = 0.6
BETA0 = 0.4
BETA_INCREMENT = 0.001


@dataclass
class PERState:
    storage: Dict[str, torch.Tensor]   # leaves [capacity, ...]
    priorities: torch.Tensor           # f32[capacity], 0 for empty slots
    ptr: int
    size: int
    beta: torch.Tensor                 # f32 scalar on the device

    @property
    def capacity(self) -> int:
        return self.priorities.shape[0]


def per_init(capacity: int, example: Dict[str, torch.Tensor], device="cuda") -> PERState:
    """Allocate a PER buffer shaped after one example transition."""
    device = resolve_device(device)
    storage = {k: torch.zeros((capacity,) + tuple(v.shape), dtype=v.dtype, device=device)
               for k, v in example.items()}
    return _empty_state(storage, capacity, device)


def per_init_fm(capacity: int, example: Dict[str, torch.Tensor], device="cuda") -> PERState:
    """Feature-major PER buffer: every storage leaf has its slot axis LAST
    (``state [S]`` becomes ``state [S, capacity]``, a scalar ``[capacity]``).
    Priorities, ptr, size and beta behave as :func:`per_init`'s; pass
    ``slot_axis=-1`` to :func:`per_add_batch` and :func:`per_sample`."""
    device = resolve_device(device)
    storage = {k: torch.zeros(tuple(v.shape) + (capacity,), dtype=v.dtype, device=device)
               for k, v in example.items()}
    return _empty_state(storage, capacity, device)


def _aligned_capacity(capacity: int, insert_block: int) -> int:
    """``capacity`` rounded up to a multiple of ``insert_block``."""
    if insert_block <= 0:
        raise ValueError(f"insert_block must be positive, got {insert_block}")
    return -(-capacity // insert_block) * insert_block


def per_init_aligned(capacity: int, insert_block: int, example: Dict[str, torch.Tensor],
                     device="cuda") -> PERState:
    """PER buffer with a block-aligned physical layout: ``capacity`` rounded up
    to a multiple of ``insert_block``, so that every
    :func:`per_add_batch_aligned` of ``insert_block`` transitions is one slice
    write at an aligned pointer and never wraps.  The live set (slots of
    nonzero priority) is always the newest ``capacity`` transitions with their
    priorities, as in a ``per_init(capacity)`` ring; older slots keep their
    storage until overwritten but have priority 0, so sampling never reaches
    them (PARITY_TORCH.md section 18)."""
    return per_init(_aligned_capacity(capacity, insert_block), example, device)


def per_init_aligned_fm(capacity: int, insert_block: int, example: Dict[str, torch.Tensor],
                        device="cuda") -> PERState:
    """Feature-major twin of :func:`per_init_aligned` (slot axis last); fill it
    with ``per_add_batch_aligned(..., slot_axis=-1)``."""
    return per_init_fm(_aligned_capacity(capacity, insert_block), example, device)


def _empty_state(storage: Dict[str, torch.Tensor], capacity: int, device) -> PERState:
    return PERState(
        storage=storage,
        priorities=torch.zeros((capacity,), dtype=torch.float32, device=device),
        ptr=0,
        size=0,
        beta=torch.tensor(BETA0, dtype=torch.float32, device=device),
    )


def per_init_kd(capacity: int, state_rows: int, scal_rows: int, device="cuda") -> PERState:
    """PER buffer for the direct-insert kernel K5: three feature-major planes,
    ``state``/``next_state`` int8 ``[state_rows, cap]`` and ``scalars`` f32
    ``[scal_rows, cap]`` (row 0 = n-step reward, 1 = action, 2 = done).
    K5 writes the planes; :func:`per_mark_batch` then marks the priorities."""
    device = resolve_device(device)
    storage = {
        "state": torch.zeros((state_rows, capacity), dtype=torch.int8, device=device),
        "next_state": torch.zeros((state_rows, capacity), dtype=torch.int8, device=device),
        "scalars": torch.zeros((scal_rows, capacity), dtype=torch.float32, device=device),
    }
    return _empty_state(storage, capacity, device)


def per_clone(state: PERState) -> PERState:
    """A deep copy (the in-place functions would otherwise share storage)."""
    return PERState({k: v.clone() for k, v in state.storage.items()},
                    state.priorities.clone(), state.ptr, state.size, state.beta.clone())


def _insert_priority(state: PERState) -> torch.Tensor:
    """The current max priority, 1.0 in an empty buffer (replay_buffer.py:150)."""
    max_p = state.priorities.max()
    return torch.where(max_p == 0.0, torch.ones_like(max_p) * ABS_ERROR_UPPER, max_p)


def per_capacity(state: PERState) -> int:
    return state.capacity


def per_add(state: PERState, item) -> PERState:
    """Insert one transition at the current max priority (1.0 in an empty buffer), in place."""
    return per_add_batch(state, _one(item, state.storage))


def per_add_batch(state: PERState, items: Dict[str, torch.Tensor], slot_axis: int = 0) -> PERState:
    """Batch insert at the current max priority (1.0 in an empty buffer), in place.

    ``slot_axis`` is the storage's slot axis: 0 for :func:`per_init` buffers,
    -1 for :func:`per_init_fm` ones (1-D leaves are the same either way)."""
    n = next(iter(items.values())).shape[slot_axis]
    cap = state.capacity
    if n > cap:
        raise ValueError(f"batch of {n} transitions exceeds buffer capacity {cap}")
    priority = _insert_priority(state)
    for k, buf in state.storage.items():
        circular_write(buf, items[k], state.ptr, axis=slot_axis)
    circular_write(state.priorities, priority.expand(n), state.ptr)
    return PERState(state.storage, state.priorities, (state.ptr + n) % cap,
                    min(state.size + n, cap), state.beta)


def per_add_batch_aligned(state: PERState, items: Dict[str, torch.Tensor], capacity: int,
                          slot_axis: int = 0) -> PERState:
    """Aligned batch insert into a :func:`per_init_aligned` (or ``_fm``) buffer
    at the current max priority, in place.

    ``capacity`` is the LOGICAL capacity; the buffer's physical capacity must
    be a multiple of this batch's ``n`` transitions and lie in ``[capacity,
    capacity + n)``.  The batch is one slice write at ``ptr``; then the ``phys
    - capacity`` slots from the new ``ptr`` (the oldest, next to be
    overwritten) get priority 0, which evicts them as the ring's wrapping
    write would.  ``size`` saturates at ``capacity``; ``ptr`` advances mod
    the physical capacity.  ``slot_axis`` as in :func:`per_add_batch`.
    """
    n = next(iter(items.values())).shape[slot_axis]
    phys = state.capacity
    if phys % n != 0:
        raise ValueError(f"aligned insert of {n} rows into physical capacity {phys}: "
                         f"capacity must be a multiple of the insert block")
    if not capacity <= phys < capacity + n:
        raise ValueError(f"physical capacity {phys} is not capacity..capacity+block for "
                         f"logical capacity {capacity} and block {n}")
    priority = _insert_priority(state)
    for k, buf in state.storage.items():
        buf.narrow(slot_axis % buf.ndim, state.ptr, n).copy_(items[k])
    state.priorities[state.ptr: state.ptr + n] = priority
    nxt = (state.ptr + n) % phys
    state.priorities[nxt: nxt + phys - capacity] = 0.0   # phys - capacity < n: never wraps
    return PERState(state.storage, state.priorities, nxt, min(state.size + n, capacity), state.beta)


def per_mark_batch(state: PERState, storage: Dict[str, torch.Tensor], n: int) -> PERState:
    """Bookkeeping of an external batch write (K5): adopt ``storage``, give the
    ``n`` slots at the ring pointer the max priority, advance ptr and size."""
    cap = state.capacity
    if n > cap:
        raise ValueError(f"batch of {n} transitions exceeds buffer capacity {cap}")
    circular_write(state.priorities, _insert_priority(state).expand(n), state.ptr)
    return PERState(storage, state.priorities, (state.ptr + n) % cap,
                    min(state.size + n, cap), state.beta)


def _block_size(capacity: int) -> int:
    """Power-of-two block width near sqrt(capacity), in [64, 1024]."""
    b = 64
    while b * b < capacity and b < 1024:
        b *= 2
    return b


def _stratified_indices(pri: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """First index where ``cumsum(pri)`` reaches each ``u`` (side='left').

    The same two-level resolution as the JAX version (block sums, a cumsum
    over blocks, then a cumsum inside the chosen block), so rounding and the
    chosen slots match it rather than a global ``cumsum`` + ``searchsorted``.
    """
    cap = pri.shape[0]
    B = _block_size(cap)
    nb = -(-cap // B)
    padded = torch.nn.functional.pad(pri, (0, nb * B - cap))
    blocks = padded.reshape(nb, B)
    bcum = torch.cumsum(blocks.sum(dim=1), dim=0)                       # [nb]
    b = (bcum[None, :] < u[:, None]).sum(dim=1)                          # [n]
    b = torch.clamp(b, max=nb - 1)
    prefix = torch.where(b > 0, bcum[torch.clamp(b - 1, min=0)], torch.zeros_like(u))
    residual = u - prefix
    icum = torch.cumsum(blocks[b], dim=1)                                # [n, B]
    j = (icum < residual[:, None]).sum(dim=1)
    return b * B + torch.clamp(j, max=B - 1)


def per_sample(state: PERState, u: torch.Tensor, n: int, slot_axis: int = 0
               ) -> Tuple[PERState, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Stratified priority sample from injected uniforms ``u[n]`` in [0, 1).

    Returns ``(state', indices, importance_weights, batch)``; ``state'`` only
    differs in the annealed beta.  ``slot_axis`` is 0 for :func:`per_init`
    buffers and -1 for :func:`per_init_fm` and :func:`per_init_kd` ones (the
    batch then keeps the minibatch axis last, e.g. ``state [S, n]``).
    """
    pri = state.priorities
    total = pri.sum()
    beta = torch.clamp(state.beta + BETA_INCREMENT, max=1.0)
    segment = total / n
    uu = (torch.arange(n, dtype=torch.float32, device=pri.device) + u.to(torch.float32)) * segment
    idx = _stratified_indices(pri, uu)
    # Snap a draw that landed on a dead (zero-priority) slot to the
    # max-priority slot, as the JAX version does.
    idx = torch.where(pri[idx] > 0.0, idx, torch.argmax(pri))
    probs = pri[idx] / total
    min_prob = torch.where(pri > 0.0, pri, torch.full_like(pri, float("inf"))).min() / total
    weights = torch.pow(probs / min_prob, -beta)
    batch = {k: buf.index_select(slot_axis % buf.ndim, idx) for k, buf in state.storage.items()}
    return PERState(state.storage, pri, state.ptr, state.size, beta), idx, weights, batch


def last_occurrence(idx: torch.Tensor) -> torch.Tensor:
    """``int64[n]``: for each entry, the position of the last entry with the same index."""
    n = idx.shape[0]
    pos = torch.arange(n, device=idx.device)
    same = idx[None, :] == idx[:, None]
    return torch.where(same, pos[None, :], -1).max(dim=1).values


def per_update(state: PERState, idx: torch.Tensor, abs_errors: torch.Tensor) -> PERState:
    """Write back clipped TD-error priorities for sampled indices, in place.

    Duplicate indices: the last occurrence wins (see the module docstring).
    Every writer of a slot writes that last value, so the scatter's order
    cannot matter and no host sync is needed.
    """
    clipped = torch.clamp(torch.abs(abs_errors) + EPSILON, max=ABS_ERROR_UPPER)
    new_p = torch.pow(clipped, ALPHA).to(torch.float32)
    state.priorities[idx] = new_p[last_occurrence(idx)]
    return state
