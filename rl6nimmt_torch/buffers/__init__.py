"""Device replay buffers (port of ``rl6nimmt_tpu.buffers``)."""

from .per import (
    PERState,
    per_add_batch,
    per_clone,
    per_init,
    per_init_kd,
    per_mark_batch,
    per_sample,
    per_update,
)
from .ring import RingState, circular_write, ring_add_batch, ring_init, ring_sample
from .sequence import SeqState, seq_flush, seq_init, seq_latest, seq_sample, seq_store, seq_store_batch

__all__ = [
    "PERState",
    "RingState",
    "SeqState",
    "circular_write",
    "per_add_batch",
    "per_clone",
    "per_init",
    "per_init_kd",
    "per_mark_batch",
    "per_sample",
    "per_update",
    "ring_add_batch",
    "ring_init",
    "ring_sample",
    "seq_flush",
    "seq_init",
    "seq_latest",
    "seq_sample",
    "seq_store",
    "seq_store_batch",
]
