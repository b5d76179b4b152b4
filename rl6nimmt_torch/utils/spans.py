"""Named spans of the port's work in a profiler trace.

:func:`span` is the one way the port opens a span.  While a profiler runs
(``torch.profiler.profile``, ``torch.autograd.profiler.profile`` or
``emit_nvtx``) it is a ``record_function`` range, which the trace holds beside
the kernels launched inside it.  Otherwise it is one shared null context: a
flag check, no allocation and no dispatcher call, so the engine and the nets
can carry spans on every call.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager that names the work inside it ``name`` in a trace."""
    if _profiler_enabled():
        return record_function(name)
    return _OFF
