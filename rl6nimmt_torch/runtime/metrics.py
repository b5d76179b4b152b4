"""Metrics, timing and profiling utilities (port of ``runtime/metrics.py``).

* :func:`timeit` -- logging wall-clock decorator (host-side code paths).
* :class:`Timer` -- accumulating block timer; ``block_on`` waits for the
  card that holds the given tensors before the clock stops.
* :func:`device_time` -- median seconds per call: CUDA events around each
  call on the card, the host clock on the CPU.
* :class:`MetricLogger` -- scalar series sink with jsonl persistence; the
  ``summary_writer`` of a DQN agent.
* :func:`grad_stats` -- per-leaf gradient magnitudes (the data behind
  :func:`plot_grad_flow`).
* :func:`plot_grad_flow` -- the reference's matplotlib gradient-flow figure
  over a gradient tree (matplotlib is imported by the call alone).
* :func:`trace` -- a ``torch.profiler`` session that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.ops import leaves_with_paths

logger = logging.getLogger(__name__)


def timeit(fn):
    """Log wall-clock duration of each call (reference various.py:53-61)."""

    def timed(*args, **kwargs):
        start = time.perf_counter()
        result = fn(*args, **kwargs)
        logger.info(f"{fn.__name__}  {(time.perf_counter() - start) * 1000:2.2f} ms")
        return result

    return timed


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a tree (a tensor, dict, list or tuple)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in tree)) if tree else set()
    return set()


def block_until_ready(tree):
    """Wait for every card that holds a tensor of ``tree``; returns ``tree``."""
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)
    return tree


class Timer:
    """Accumulating block timer: ``with timer.measure("step"): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, name: str, block_on: Any = None):
        start = time.perf_counter()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        self.totals[name] += time.perf_counter() - start
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }


def device_time(fn, *args, iters: int = 10, warmup: int = 1) -> float:
    """Median seconds per call of ``fn(*args)``: CUDA events around each call
    when its arguments or outputs live on a card, the host clock otherwise."""
    out = None
    for _ in range(warmup):
        out = block_until_ready(fn(*args))
    devices = _cuda_devices(list(args)) | _cuda_devices(out)
    times = []
    for _ in range(iters):
        if devices:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            block_until_ready(fn(*args))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            start = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - start)
    return sorted(times)[len(times) // 2]


class MetricLogger:
    """Scalar series recorder with optional jsonl persistence.

    Drop-in for the reference's optional ``summary_writer`` hooks: pass an
    instance as ``summary_writer`` to a DQN agent and ``add_scalar`` records
    the series.
    """

    def __init__(self, path: Optional[str] = None):
        self.series: Dict[str, list] = defaultdict(list)
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def add_scalar(self, name: str, value, step: int) -> None:
        value = float(value)
        self.series[name].append((step, value))
        if self._fh:
            self._fh.write(json.dumps({"name": name, "step": step, "value": value}) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def grad_stats(grads: Any) -> Dict[str, Dict[str, float]]:
    """Per-leaf |grad| mean/max, keyed by tree path (``trunk/0/w``) -- the
    plot_grad_flow data (various.py:11-38)."""
    stats = {}
    for path, leaf in leaves_with_paths(grads):
        arr = np.abs(leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
        stats["/".join(path)] = {"mean_abs": float(arr.mean()), "max_abs": float(arr.max())}
    return stats


def plot_grad_flow(grads: Any, path: Optional[str] = None, ylim: float = 0.02):
    """Gradient-flow bar chart (reference various.py:11-38) of a gradient tree.

    Overlaid max/mean |grad| bars per layer, vertical layer names, zero line,
    zoomed y-axis; bias leaves (names ending in ``/b`` or ``/sigma_b``) are
    dropped like the reference's ``"bias" not in n`` filter.  Writes the
    figure to ``path`` (or returns it) with the Agg backend, so it works on a
    machine without a display.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.lines import Line2D

    stats = grad_stats(grads)
    layers, ave_grads, max_grads = [], [], []
    for name, s in stats.items():
        if name.endswith("/b") or name.endswith("/sigma_b"):
            continue
        layers.append(name)
        ave_grads.append(s["mean_abs"])
        max_grads.append(s["max_abs"])

    fig, ax = plt.subplots(figsize=(max(6, len(layers) * 0.8), 4))
    ax.bar(np.arange(len(max_grads)), max_grads, alpha=0.1, lw=1, color="c")
    ax.bar(np.arange(len(ave_grads)), ave_grads, alpha=0.1, lw=1, color="b")
    ax.hlines(0, 0, len(ave_grads) + 1, lw=2, color="k")
    ax.set_xticks(range(len(layers)))
    ax.set_xticklabels(layers, rotation="vertical")
    ax.set_xlim(left=-0.5, right=len(ave_grads) - 0.5 if ave_grads else 0.5)
    ax.set_ylim(bottom=-0.001, top=ylim)  # zoom on the small-gradient region
    ax.set_xlabel("Layers")
    ax.set_ylabel("average gradient")
    ax.set_title("Gradient flow")
    ax.grid(True)
    ax.legend(
        [Line2D([0], [0], color="c", lw=4), Line2D([0], [0], color="b", lw=4),
         Line2D([0], [0], color="k", lw=4)],
        ["max-gradient", "mean-gradient", "zero-gradient"],
    )
    fig.tight_layout()
    if path is not None:
        fig.savefig(path)
        plt.close(fig)
        return path
    return fig


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` session (CPU, and the card when there is one);
    on exit writes its Chrome trace to ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
