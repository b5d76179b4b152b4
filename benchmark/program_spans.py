"""Per-step milliseconds of the program's own spans, summed over the spans
whose names share a prefix (``engine.``, ``nets.``, ``arena.seat.``), read
from the traced window's existing :class:`~benchmark.trace_reader.Trace` fields."""


def _sum(table: dict, prefix: str) -> float:
    return sum(s for name, s in table.items() if name.startswith(prefix))


def present(trace, prefix: str) -> bool:
    """Whether the program launched work under any span of ``prefix`` in the
    window: a program without such spans reads None, not 0."""
    return trace is not None and any(name.startswith(prefix) for name in trace.span_device_s)


def device_ms(run, prefix: str):
    """Device ms a step of the kernels launched under any span of ``prefix``
    (nested spans included); None without a trace or without such a span."""
    if not present(run.trace, prefix):
        return None
    return _sum(run.trace.span_device_s, prefix) / run.trace.steps * 1e3


def idle_ms(run, prefix: str):
    """The device's idle ms a step while a span of ``prefix`` was the innermost
    open host span; None without a trace or without such a span."""
    if not present(run.trace, prefix):
        return None
    return _sum(run.trace.idle_by_span, prefix) / run.trace.steps * 1e3
