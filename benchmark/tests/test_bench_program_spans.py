"""The readers of the program's own spans (``engine_device_ms``,
``net_device_ms``, ``seat_device_ms``, ``engine_idle_ms``) on hand-made
kineto events: nested spans count in each metric they belong to, idle gaps go
to the innermost span, and a program without the spans reads None."""

import importlib

import pytest
from torch.autograd import DeviceType

from benchmark.harness import Run, Window
from benchmark.tests.test_bench_yardstick import Event
from benchmark.trace_reader import read_events

C, D = DeviceType.CPU, DeviceType.CUDA
READERS = ("engine_device_ms", "net_device_ms", "seat_device_ms", "engine_idle_ms")


def _read(metric, events, steps=1):
    run = Run(cell=None, setup_s=0.0, window=Window(0), trace=read_events(events, steps))
    return importlib.import_module(f"benchmark.metrics.{metric}").read(run)


def _close(a, b):
    return abs(a - b) < 1e-12


def _train_step():
    """One step: a rollout whose turn (``engine.step``) launches K1 and whose
    ``nets.policy`` launches a GEMM, then a backward outside both."""
    return [
        Event("bench.window", C, 0, 1000, 1, True), Event("bench.step", C, 0, 900, 2, True),
        Event("reinforce.rollout", C, 10, 500, 3, True), Event("nets.policy", C, 20, 100, 4, True),
        Event("engine.step", C, 200, 200, 5, True), Event("reinforce.backward", C, 600, 200, 6, True),
        Event("cudaLaunchKernel", C, 30, 5, 100), Event("gemm", D, 40, 100, 100),
        Event("cudaLaunchKernel", C, 250, 5, 101), Event("resolve_turn_kernel<false, 4, 4, 6>", D, 260, 200, 101),
        Event("cudaLaunchKernel", C, 650, 5, 102), Event("gemm_backward", D, 660, 300, 102),
    ]


def test_engine_step_nested_in_the_rollout_counts_in_both():
    events = _train_step()
    assert _close(_read("engine_device_ms", events), 200e-9 * 1e3)
    assert _close(_read("rollout_device_ms", events), 300e-9 * 1e3)      # the GEMM and K1
    assert _close(_read("net_device_ms", events), 100e-9 * 1e3)         # the forward only
    assert _close(_read("backward_device_ms", events), 300e-9 * 1e3)
    assert _close(_read("engine_device_ms", events, steps=2), 100e-9 * 1e3)


def test_a_gap_under_engine_observe_is_the_engines_idle_and_not_bench_step():
    events = [
        Event("bench.window", C, 0, 1000, 1, True), Event("bench.step", C, 0, 1000, 2, True),
        Event("engine.observe", C, 100, 300, 3, True),
        Event("cudaLaunchKernel", C, 10, 5, 100), Event("cat", D, 20, 80, 100),             # busy 20-100
        Event("cudaLaunchKernel", C, 350, 5, 101), Event("cat", D, 400, 600, 101),          # busy 400-1000
    ]
    trace = read_events(events, 1)
    idle = dict(trace.breakdown()["idle_gaps"])
    # Gaps 0-20 (under bench.step) and 100-400 (under engine.observe).
    assert _close(idle["engine.observe"], 300e-9) and _close(idle["bench.step"], 20e-9)
    assert _close(_read("engine_idle_ms", events), 300e-9 * 1e3)
    assert _close(_read("engine_device_ms", events), 600e-9 * 1e3)


def test_nets_q_nested_in_the_dqn_seat_counts_in_both():
    events = [
        Event("bench.window", C, 0, 1000, 1, True), Event("bench.step", C, 0, 1000, 2, True),
        Event("arena.seat.dqn", C, 10, 300, 3, True), Event("nets.q", C, 20, 100, 4, True),
        Event("arena.seat.random", C, 400, 100, 5, True),
        Event("cudaLaunchKernel", C, 30, 5, 100), Event("gemm", D, 40, 150, 100),            # the Q forward
        Event("cudaLaunchKernel", C, 200, 5, 101), Event("argmax", D, 210, 50, 101),         # the seat's argmax
        Event("cudaLaunchKernel", C, 450, 5, 102), Event("pick", D, 460, 30, 102),           # a random seat
    ]
    assert _close(_read("net_device_ms", events), 150e-9 * 1e3)
    assert _close(_read("seat_device_ms", events), 230e-9 * 1e3)
    assert _read("engine_device_ms", events) is None


@pytest.mark.parametrize("metric", READERS)
def test_each_reader_is_none_without_its_span(metric):
    events = [
        Event("bench.window", C, 0, 1000, 1, True), Event("bench.step", C, 0, 600, 2, True),
        Event("reinforce.rollout", C, 10, 300, 3, True),
        Event("cudaLaunchKernel", C, 20, 5, 100), Event("gemm", D, 100, 200, 100),
    ]
    assert _read(metric, events) is None
    run = Run(cell=None, setup_s=0.0, window=Window(0), trace=None)
    assert importlib.import_module(f"benchmark.metrics.{metric}").read(run) is None
