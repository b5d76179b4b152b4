"""Device replay buffers (port of ``rl6nimmt_tpu.buffers``)."""

from .per import (
    PERState,
    per_add,
    per_add_batch,
    per_capacity,
    per_clone,
    per_init,
    per_init_kd,
    per_mark_batch,
    per_sample,
    per_update,
)
from .ring import RingState, circular_write, ring_add, ring_add_batch, ring_capacity, ring_clear, ring_init, ring_sample
from .sequence import (
    SeqState,
    seq_capacity,
    seq_flush,
    seq_init,
    seq_latest,
    seq_sample,
    seq_store,
    seq_store_batch,
)

__all__ = [
    "PERState",
    "per_add",
    "per_add_batch",
    "per_capacity",
    "per_init",
    "per_init_kd",
    "per_mark_batch",
    "per_sample",
    "per_update",
    "RingState",
    "ring_add",
    "ring_add_batch",
    "ring_capacity",
    "ring_clear",
    "ring_init",
    "ring_sample",
    "SeqState",
    "seq_capacity",
    "seq_flush",
    "seq_init",
    "seq_latest",
    "seq_sample",
    "seq_store",
    "seq_store_batch",
    # the port's own: the in-place write and the PER copy
    "circular_write",
    "per_clone",
]
