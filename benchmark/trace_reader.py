"""The trace reader: one traced window of steps, read from the profiler's raw
kineto events, and what every per-layer metric and the ``breakdown`` take from it.

* Device work is every device event but the device-side copies of the host
  spans and the synchronizations: kernels, copies and sets.  The busy time is
  the union of their intervals inside the window; the window runs from the
  first traced step's call to the last one's read.
* A kernel belongs to the host spans (``record_function`` ranges: the
  benchmark's ``bench.*`` and the program's own, such as ``reinforce.*``) that
  were open when the host launched it: the launch is the runtime event with
  the kernel's correlation id, so the device's clock is matched to no span.
* An idle gap of the device is named by the innermost host span open over it,
  split where that span changes.
* The host's own time of a step is its ``bench.step`` span less the CUDA
  runtime's calls inside it (a launch that waits for room in the card's queue
  waits inside such a call).

Reading the raw events, not the profiler's parsed event tree, keeps this to
seconds for hundreds of thousands of events.
"""

from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

from torch.autograd import DeviceType

LAUNCH_PREFIXES = ("cuda", "cuLaunch", "cuMemcpy", "cuMemset")
COPY_PREFIXES = ("Memcpy", "Memset")
OUTSIDE = "(no span)"


@dataclass
class Trace:
    """One traced window of ``steps`` steps."""

    steps: int
    window_s: float
    busy_s: float
    launches: int                                   # kernel events
    by_kernel: Dict[str, Tuple[float, int]]         # name -> (device seconds, events)
    span_device_s: Dict[str, float]                 # span name -> device seconds of the kernels it launched
    idle_by_span: Dict[str, float]                  # innermost span -> idle device seconds under it
    matched_share: float = 1.0                      # kernels whose launch was found
    step_host_s: float = 0.0                        # host time in the step spans outside runtime calls
    notes: List[str] = field(default_factory=list)

    def kernel_mean_s(self, needle: str):
        """Mean device seconds an event of the kernels whose name holds ``needle``; None if none ran."""
        hits = [(s, n) for name, (s, n) in self.by_kernel.items() if needle in name]
        count = sum(n for _, n in hits)
        return sum(s for s, _ in hits) / count if count else None

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_kernel.items(), key=lambda kv: kv[1][0], reverse=True)[:top]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: kv[1], reverse=True)[:top]
        return {"device_ops": [[name[:100], s] for name, (s, _) in ops],
                "idle_gaps": [[name, s] for name, s in gaps if s > 0]}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _segments(spans):
    """``(starts, stacks)``: from each start on, the tuple of span names open
    (outermost first) until the next start."""
    edges = sorted([(a, 1, i) for i, (a, b, _) in enumerate(spans)] + [(b, 0, i) for i, (a, b, _) in enumerate(spans)])
    open_, starts, stacks = [], [], []
    for t, kind, i in edges:
        if kind:
            open_.append(i)
        elif i in open_:
            open_.remove(i)
        starts.append(t)
        stacks.append(tuple(spans[j][2] for j in sorted(open_, key=lambda j: spans[j][0])))
    return starts, stacks


def _stack_at(starts, stacks, t):
    k = bisect.bisect_right(starts, t) - 1
    return stacks[k] if k >= 0 else ()


def classify(e) -> str:
    """``span``, ``launch`` (a runtime call on the host), ``kernel``, ``copy`` or ``other``.

    Read from the event's device, its user-annotation flag and its name, which
    every recent PyTorch gives (its activity type only some do)."""
    name = e.name()
    if e.device_type() == DeviceType.CPU:
        if e.is_user_annotation():
            return "span"
        return "launch" if name.startswith(LAUNCH_PREFIXES) else "other"
    if e.is_user_annotation() or "Sync" in name:
        return "other"
    return "copy" if name.startswith(COPY_PREFIXES) else "kernel"


def host_outside_runtime(spans, calls, name: str) -> float:
    """Seconds inside the host spans called ``name`` outside the runtime's calls
    (``calls``: their ``(start, end)``), in nanoseconds in, seconds out."""
    calls = _union(calls)
    starts = [a for a, _ in calls]
    total = 0
    for a, b, span in spans:
        if span != name:
            continue
        total += b - a
        for c, d in calls[max(bisect.bisect_right(starts, a) - 1, 0):]:
            if c >= b:
                break
            total -= max(min(d, b) - max(c, a), 0)
    return total / 1e9


def read_events(events, steps: int, window_span: str = "bench.window", step_span: str = "bench.step") -> Trace:
    """A :class:`Trace` from the kineto events of one traced window."""
    spans, launch_at, work, calls = [], {}, [], []
    window = None
    for e in events:
        kind = classify(e)
        if kind == "span":
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.name() == window_span:
                window = (a, b)
            spans.append((a, b, e.name()))
        elif kind == "launch":
            launch_at[e.correlation_id()] = e.start_ns()
            calls.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif kind in ("kernel", "copy"):
            work.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), kind, e.correlation_id()))
    if window is None:
        raise RuntimeError(f"the trace holds no {window_span!r} span")
    if not any(k == "kernel" for *_, k, _ in work):
        raise RuntimeError("the trace holds no kernel event: the profiler saw no device work")
    starts, stacks = _segments(spans)
    w0, w1 = window
    by_kernel, span_dev, matched, kernels = {}, {}, 0, 0
    for a, b, name, kind, corr in work:
        if b <= w0 or a >= w1:
            continue
        s = (min(b, w1) - max(a, w0)) / 1e9
        tot, n = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (tot + s, n + 1)
        if kind == "kernel":
            kernels += 1
        at = launch_at.get(corr)
        if at is None:
            continue
        matched += 1
        for span in set(_stack_at(starts, stacks, at)):
            span_dev[span] = span_dev.get(span, 0.0) + s
    busy = _union([(max(a, w0), min(b, w1)) for a, b, *_ in work if b > w0 and a < w1])
    idle_by_span: Dict[str, float] = {}
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if prev < w1:
        gaps.append((prev, w1))
    for a, b in gaps:
        k, t = bisect.bisect_right(starts, a) - 1, a
        while t < b:
            stack = stacks[k] if k >= 0 else ()
            end = min(starts[k + 1], b) if k + 1 < len(starts) else b
            name = stack[-1] if stack else OUTSIDE
            idle_by_span[name] = idle_by_span.get(name, 0.0) + max(end - t, 0) / 1e9
            t, k = max(end, t), k + 1
    n_work = sum(1 for a, b, *_ in work if b > w0 and a < w1)
    trace = Trace(steps=steps, window_s=(w1 - w0) / 1e9, busy_s=sum(b - a for a, b in busy) / 1e9,
                  launches=kernels, by_kernel=by_kernel, span_device_s=span_dev, idle_by_span=idle_by_span,
                  matched_share=matched / n_work if n_work else 0.0,
                  step_host_s=host_outside_runtime(spans, calls, step_span))
    if trace.matched_share < 0.99:
        trace.notes.append(f"only {trace.matched_share:.4f} of the device events matched a launch")
    return trace


def trace_steps(run_window: Callable[[], int], sync: Callable[[], None]) -> Trace:
    """Run one window of steps (``run_window()`` runs it and returns how many
    steps it ran) under the profiler, inside a ``bench.window`` span, and read
    the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            steps = run_window()
        sync()
    trace = read_events(prof.profiler.kineto_results.events(), steps)
    for note in trace.notes:
        print(f"trace: {note}", file=sys.stderr)
    return trace
