"""The FLOP and byte counts against hand counts at one small shape, and the
trace reader on hand-made events."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from benchmark import flops
from benchmark.trace_reader import read_events


def test_k1_bytes_and_operations_by_hand():
    # 2 games, P=4, R=4, T=6: board 24 + lengths 4 + actions 4 int32 in, board, lengths, rewards out.
    assert flops.k1_bytes(2, 4, 4, 6) == 2 * (4 * 2 * (24 + 4 + 4))
    # 4 sub-plays of 34 operations and the 16 comparisons of the ordering, a game.
    assert flops.k1_ops(2, 4) == 2 * (4 * 34 + 16)
    # At the cells' G the bytes bound it.
    assert flops.bound_s(flops.k1_bytes(65536, 4, 4, 6), flops.k1_ops(65536, 4)) == \
        flops.k1_bytes(65536, 4, 4, 6) / flops.HBM_BYTES_PER_S


def test_policy_flops_by_hand():
    # Input 3 (card + 2 features), hidden (4,), head (1,); hands of 2, one seat:
    # turn 0: shared 2*2*4 + 2 cards * (2*4 rank-1 + 2*4*1 head) = 16 + 32; turn 1: 16 + 16.
    net = {"input_size": 3, "hidden_sizes": [4], "head_sizes": [1]}
    assert flops.policy_flops(net, 1, 2) == 80
    assert flops.policy_flops(net, 5, 2) == 400
    # Two hidden layers add 2*4*5 a live card: 3 live cards over the two turns.
    net2 = {"input_size": 3, "hidden_sizes": [4, 5], "head_sizes": [1]}
    assert flops.policy_flops(net2, 1, 2) == 2 * 16 + 3 * (8 + 40 + 10)


def test_mlp_flops_by_hand():
    net = {"input_size": 47, "hidden_sizes": [64], "head_sizes": [1, 104]}
    assert flops.mlp_flops(net, 3) == 3 * (2 * 47 * 64 + 2 * 64 + 2 * 64 * 104)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert flops.bound_s(3.35e12, 0) == 1.0
    assert flops.bound_s(0, 67e12) == 1.0
    assert flops.bound_s(3.35e12, 2 * 67e12) == 2.0


class Event:
    def __init__(self, name, device, start, dur, corr=0, span=False):
        self.v = SimpleNamespace(name=name, device=device, start=start, dur=dur, corr=corr, span=span)

    def name(self): return self.v.name
    def device_type(self): return self.v.device
    def start_ns(self): return self.v.start
    def duration_ns(self): return self.v.dur
    def correlation_id(self): return self.v.corr
    def is_user_annotation(self): return self.v.span


def test_trace_reader_attributes_kernels_and_idle_gaps():
    C, D = DeviceType.CPU, DeviceType.CUDA
    events = [
        Event("bench.window", C, 0, 1000, 1, True), Event("bench.step", C, 0, 600, 2, True),
        Event("reinforce.rollout", C, 10, 300, 3, True), Event("bench.read", C, 600, 400, 4, True),
        Event("aten::mm", C, 20, 5, 100),                          # an op whose id equals a launch's: not a launch
        Event("cudaLaunchKernel", C, 20, 5, 100), Event("gemm", D, 100, 200, 100),
        Event("cudaLaunchKernel", C, 400, 5, 101), Event("resolve_turn_kernel<false, 4, 4, 6>", D, 450, 100, 101),
        Event("cudaMemcpyAsync", C, 610, 5, 102), Event("Memcpy DtoH (Device -> Pinned)", D, 700, 50, 102),
        Event("reinforce.rollout", D, 100, 200, 3, True),          # the span's device-side copy: no work
        Event("gemm", D, 1100, 50, 103),                           # after the window
    ]
    t = read_events(events, steps=1)
    assert t.window_s == 1000e-9 and abs(t.busy_s - 350e-9) < 1e-15
    assert t.launches == 2 and t.matched_share == 1.0
    assert abs(t.span_device_s["reinforce.rollout"] - 200e-9) < 1e-15
    assert abs(t.span_device_s["bench.step"] - 300e-9) < 1e-15
    assert abs(t.span_device_s["bench.read"] - 50e-9) < 1e-15
    assert abs(t.kernel_mean_s("resolve_turn_kernel") - 100e-9) < 1e-15
    idle = dict(t.breakdown()["idle_gaps"])
    # Gaps 0-100, 300-450, 550-700, 750-1000 split by the innermost span open over them.
    assert abs(idle["bench.step"] - 200e-9) < 1e-15
    assert abs(idle["reinforce.rollout"] - 100e-9) < 1e-15
    assert abs(idle["bench.read"] - 350e-9) < 1e-15
    assert [name for name, _ in t.breakdown()["device_ops"]][0] == "gemm"
    # The step span's 600 ns less its two launches' 5 ns each; the read's copy call lies outside it.
    assert abs(t.step_host_s - 590e-9) < 1e-15
