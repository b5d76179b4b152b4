"""One run of one cell: set-up, the measured window, an optional traced window,
the check against the plain reference, and the result line.

Everything a cell is made of is found by name (``BENCHMARK.json`` lists the
cells):

* ``configs/<config>.json``: the configuration's sizes;
* ``traffic/<traffic>.json``: the traffic mix; its ``entry`` names the code that runs it;
* ``entries/<entry>.py``: ``build(config, traffic, seed, device) -> cell``,
  the calls into the program;
* ``metrics/<metric>.py``: ``read(run) -> number or None``, one a metric.

A cell offers ``G`` (games a step), ``rules``, ``env_steps`` (game turns a
step), ``model_flops`` (a step's), ``first_step``, ``warm_up()``, ``step(i) ->
handle`` (the call into the program), ``read(handle)`` (the host read that ends
the step), ``release()`` and ``check() -> (checks, failed)``: each compared
number with its limit.

The traffic's ``in_flight`` (1 if it has none) is how many steps the window
has sent and not yet read while it sends the next: with 2, the host sends
step ``i + 1`` before it waits for step ``i``, so the card has a step queued
while the host reads, and a short stall of the host costs no card time.  The
card's launch queue holds about 1,000 launches, about one step, before a launch
blocks the host; ``main`` scales it by ``LAUNCH_QUEUES`` (the CUDA driver's
``CUDA_SCALE_LAUNCH_QUEUES``, set before CUDA starts) to about 4,000, so that
three or four steps can wait on the card.
"""

from __future__ import annotations

import argparse
import collections
import gc
import importlib
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

from .common import HERE, ROOT, load_json

FORBIDDEN = ("jax", "jaxlib", "flax", "rl6nimmt_tpu")
TRACE_SECONDS = 3.0
TRACE_STEPS = (5, 20)
LAUNCH_QUEUES = "4x"  # the largest scale the driver offers


def process_start() -> float:
    """Epoch seconds at which this process started (its set-up begins there)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


@dataclass
class Window:
    first: int
    step_s: List[float] = field(default_factory=list)       # host clock, from read to read
    dispatch_s: List[float] = field(default_factory=list)   # host clock, the call into the program
    card_step_s: List[float] = field(default_factory=list)  # the card's clock, from step end to step end
    seconds: float = 0.0

    @property
    def steps(self) -> int:
        return len(self.step_s)


@dataclass
class Run:
    """What the metric readers read."""

    cell: object
    setup_s: float
    window: Window
    trace: Optional[object] = None


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json and print its result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def find_cell(bench: dict, name: str):
    """``(workload, config, traffic)`` of the cell ``name``, each read from its file."""
    try:
        wl = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json") from None
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    return wl, config, traffic


def metrics_of(bench: dict, wl: dict, trace: bool) -> list:
    """The cell's metrics of its kind: ``end_to_end`` untraced (each in every
    cell, or in the cells its ``workloads`` lists), ``per_layer`` traced (in the
    cells its ``workloads`` lists)."""
    if trace:
        return [m for m in bench["per_layer"] if wl["name"] in m["workloads"]]
    return [m for m in bench["end_to_end"] if "workloads" not in m or wl["name"] in m["workloads"]]


def entry_module(traffic: dict):
    return importlib.import_module(f"benchmark.entries.{traffic['entry']}")


class Reader:
    """Reads a step's results once the step is done.  On a card it records a
    timed event right after the step's work and reads on a stream of its own
    behind that event, so that a read waits for its own step and not for the
    steps sent after it; the events give each step's time on the card's clock."""

    def __init__(self, dev):
        import torch

        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.torch, self.stream = torch, torch.cuda.Stream(dev)

    def mark(self):
        if not self.cuda:
            return None
        event = self.torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def read(self, cell, handle, mark) -> None:
        if not self.cuda:
            cell.read(handle)
            return
        with self.torch.cuda.stream(self.stream):
            self.stream.wait_event(mark)
            cell.read(handle)

    @staticmethod
    def between(marks) -> List[float]:
        """Seconds on the card's clock from each mark to the next."""
        return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])] if marks and marks[0] else []


def measure(cell, first: int, record, reader: Reader, in_flight: int = 1, seconds: Optional[float] = None,
            steps: Optional[int] = None) -> Window:
    """Steps sent back to back, each read once ``in_flight`` steps are unread,
    until ``seconds`` have passed or ``steps`` were sent.  Then nothing more
    is sent, every sent step is read, and the window ends at the last read: all
    of that work over all of that time.  A step's time runs from the read that
    ended the step before (the window's start, for the first) to its own read
    on the host's clock, and on the card's from the end of the step before
    (the window's start) to its own end."""
    window = Window(first)
    pending = collections.deque()
    marks = [reader.mark()]
    t_start = last = time.perf_counter()
    i = first
    while True:
        t0 = time.perf_counter()
        with record("bench.step"):
            pending.append((cell.step(i), reader.mark()))
        window.dispatch_s.append(time.perf_counter() - t0)
        marks.append(pending[-1][1])
        i += 1
        done = i - first >= steps if steps is not None else time.perf_counter() - t_start >= seconds
        while pending and (done or len(pending) >= in_flight):
            with record("bench.read"):
                reader.read(cell, *pending.popleft())
            now = time.perf_counter()
            window.step_s.append(now - last)
            last = now
        if done:
            break
    window.seconds = last - t_start
    window.card_step_s = reader.between(marks)
    return window


def forbidden_modules() -> list:
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def run_cell(bench: dict, args, device: str = "cuda", started: Optional[float] = None, overrides=None):
    """The result of one run (a dict), or raise.  ``overrides`` replaces traffic
    keys (a test's small sizes); ``device="cpu"`` runs the program's plain paths."""
    import torch
    from torch.profiler import record_function

    started = process_start() if started is None else started
    wl, config, traffic = find_cell(bench, args.workload)
    traffic = {**traffic, **(overrides or {})}
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cell = entry_module(traffic).build(config, traffic, args.seed, dev)
    reader, in_flight = Reader(dev), int(traffic.get("in_flight", 1))
    cell.warm_up()
    sync()
    gc.collect()
    gc.freeze()
    setup_s = time.time() - started

    window = measure(cell, cell.first_step, record_function, reader, in_flight, seconds=args.seconds)
    run = Run(cell, setup_s, window)
    if args.trace:
        per_step = window.seconds / window.steps
        n = int(min(max(TRACE_SECONDS / per_step, TRACE_STEPS[0]), TRACE_STEPS[1]))
        from .trace_reader import trace_steps

        run.trace = trace_steps(lambda: measure(cell, cell.first_step + window.steps, record_function, reader,
                                                in_flight, steps=n).steps, sync)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    metrics = {}
    for m in metrics_of(bench, wl, bool(args.trace)):
        value = importlib.import_module(f"benchmark.metrics.{m['name']}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    cell.release()
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = cell.check()
    ms = sorted(s * 1e3 for s in window.step_s)
    card = sorted(s * 1e3 for s in window.card_step_s) or [0.0]
    print(f"note steps {len(ms)} median_ms {statistics.median(ms)!r} max_ms {ms[-1]!r} "
          f"dispatch_median_ms {statistics.median(window.dispatch_s) * 1e3!r} "
          f"card_median_ms {statistics.median(card)!r} card_max_ms {card[-1]!r}", file=sys.stderr)
    for key, value in getattr(cell, "notes", {}).items():
        print(f"note {key} {value!r}", file=sys.stderr)
    attempted = window.steps + (run.trace.steps if run.trace else 0)
    result = {"correct": failed == 0 and all(v <= lim for v, lim in checks.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics}
    if dev.type == "cuda":
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": wl["chips"],
                            "memory_peak_bytes": peak}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.trace:
        result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    started = process_start()
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    wl, _, _ = find_cell(bench, args.workload)
    os.environ["CUDA_SCALE_LAUNCH_QUEUES"] = LAUNCH_QUEUES
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(bench, args, "cuda", started)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded modules it must not: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
