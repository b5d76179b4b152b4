"""Host-side replay buffers for the interactive (single-game) agent path
(port of ``buffers/host.py``; NumPy only, so the port keeps its own copy).

The device buffers in :mod:`ring`/:mod:`per`/:mod:`sequence` serve the
vectorized runtime; these NumPy twins serve the per-step host agents.
Sampling semantics match the device versions (and the reference's sum-tree,
replay_buffer.py:15-203): stratified segment draws resolved against the
priority prefix-sum.

The prefix-sum scan is the hot host kernel; when the native sampler
(``native/sumtree.cpp``, :mod:`.sumtree_native`) builds, :class:`HostPriorityBuffer`
uses it, else NumPy's ``searchsorted``, which gives the same indices.  This is
a host sampler's choice between two equal implementations, not a device
fallback.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import sumtree_native

ABS_ERROR_UPPER = 1.0
EPSILON = 0.01
ALPHA = 0.6
BETA0 = 0.4
BETA_INCREMENT = 0.001


def _native():
    """The native sampler module, or None when it cannot be built here."""
    try:
        sumtree_native.library()
    except OSError:
        return None
    return sumtree_native


class HostHistory:
    """Uniform ring buffer of dict records (reference History, rb.py:206-271)."""

    def __init__(self, max_length: Optional[int] = None):
        self.max_length = max_length
        self._records: List[dict] = []
        self._ptr = 0

    def store(self, **record) -> None:
        if self.max_length is not None and len(self._records) >= self.max_length:
            self._records[self._ptr] = record
            self._ptr = (self._ptr + 1) % self.max_length
        else:
            self._records.append(record)

    def sample(self, n: int):
        idx = np.random.choice(len(self._records), size=n, replace=False)
        batch = self._collate([self._records[i] for i in idx])
        return idx, None, batch

    def rollout(self, n: Optional[int] = None):
        records = self._records if n is None else self._records[-n:]
        return self._collate(records)

    def clear(self) -> None:
        self._records = []
        self._ptr = 0

    def __len__(self) -> int:
        return len(self._records)

    @staticmethod
    def _collate(records: List[dict]) -> Dict[str, list]:
        return {k: [r[k] for r in records] for k in records[0]}


class HostSequentialHistory(HostHistory):
    """Sequence ring buffer: twin of the reference ``SequentialHistory``
    (replay_buffer.py:274-302).

    ``store`` accumulates steps into a current-sequence dict-of-lists and
    injects the per-step ``first`` flag (True exactly on each sequence's
    first step); ``flush`` pushes the whole sequence as ONE record into the
    ring.  The record layout matches the reference's: each record field is
    the list of per-step values, plus ``record["first"] = [True, False, ...]``.
    Uniform ``sample``/``rollout`` then return dict-of-lists-of-sequences,
    the same nesting the reference's ``iter_flatten`` unpacking consumes.
    """

    def __init__(self, max_length: Optional[int] = None):
        super().__init__(max_length)
        self.current_sequence: dict = {}

    def current_sequence_length(self) -> int:
        if not self.current_sequence:
            return 0
        return len(next(iter(self.current_sequence.values())))

    def store(self, **kwargs) -> None:
        if self.current_sequence_length() == 0:
            for key, val in kwargs.items():
                self.current_sequence[key] = [val]
            self.current_sequence["first"] = [True]
        else:
            for key, val in kwargs.items():
                self.current_sequence[key].append(val)
            self.current_sequence["first"].append(False)

    def flush(self) -> None:
        """Push the current sequence to long-term memory as one record."""
        assert self.current_sequence_length() > 0
        super().store(**self.current_sequence)
        self.current_sequence = {}


class HostPriorityBuffer:
    """Prioritized replay with stratified prefix-sum sampling (host path)."""

    def __init__(self, max_length: int):
        if max_length is None:
            raise ValueError("HostPriorityBuffer needs max_length")
        self.capacity = int(max_length)
        self._records = np.empty(self.capacity, dtype=object)
        self.priorities = np.zeros(self.capacity, dtype=np.float64)
        self._ptr = 0
        self._size = 0
        self.beta = BETA0

    def store(self, **record) -> None:
        max_p = self.priorities.max() if self._size else 0.0
        self.priorities[self._ptr] = max_p if max_p > 0 else ABS_ERROR_UPPER
        self._records[self._ptr] = record
        self._ptr = (self._ptr + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)

    def sample(self, n: int) -> Tuple[np.ndarray, np.ndarray, Dict[str, list]]:
        self.beta = min(1.0, self.beta + BETA_INCREMENT)
        pri = self.priorities
        total = pri.sum()
        u = (np.arange(n) + np.random.random(n)) * (total / n)
        native = _native()
        if native is not None:
            idx = native.stratified_sample(pri, u)
        else:
            idx = np.searchsorted(np.cumsum(pri), u, side="left")
        idx = np.clip(idx, 0, self._size - 1)

        probs = pri[idx] / total
        min_prob = pri[: self._size].min() / total
        weights = np.power(probs / min_prob, -self.beta)
        batch = HostHistory._collate([self._records[i] for i in idx])
        return idx, weights, batch

    def batch_update(self, idx: np.ndarray, abs_errors: np.ndarray) -> None:
        native = _native()
        if native is not None:
            native.update_priorities(
                self.priorities, idx, np.asarray(abs_errors),
                EPSILON, ABS_ERROR_UPPER, ALPHA,
            )
            return
        abs_errors = np.asarray(abs_errors, dtype=np.float64)
        clipped = np.minimum(np.abs(abs_errors) + EPSILON, ABS_ERROR_UPPER)
        self.priorities[np.asarray(idx, dtype=np.int64)] = clipped**ALPHA

    def __len__(self) -> int:
        return self._size
