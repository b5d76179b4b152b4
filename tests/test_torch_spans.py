"""The port's spans (``utils/spans.py``): one shared null context while no
profiler runs, and under the profiler the engine's, the nets' and the arena
seats' spans where the work happens, in an arena match and a REINFORCE step,
with the same results as without it."""

import contextlib
from collections import Counter

import torch
from torch.profiler import ProfilerActivity, profile

from rl6nimmt_torch import agents as tag
from rl6nimmt_torch.agents.dqn import Adam, tree_leaves
from rl6nimmt_torch.engine import EnvConfig
from rl6nimmt_torch.nets import MLPSpec, mlp_init
from rl6nimmt_torch.runtime import arena as tarena
from rl6nimmt_torch.runtime import seat_policy_of
from rl6nimmt_torch.runtime.metrics import span
from rl6nimmt_torch.runtime.vector import make_reinforce_train_step

G = 8
CFG = EnvConfig(4)
PREFIXES = ("engine.", "nets.", "arena.", "reinforce.")


def _spans(prof) -> Counter:
    return Counter(e.name for e in prof.events() if e.name.startswith(PREFIXES))


def _arena():
    """A match of a noisy dueling D3QN in seat 0 against three random seats."""
    dqn = tag.Noisy_D3QN_PRB_NStep(seed=3, hidden_sizes=(16,), device="cpu")
    policy, params = seat_policy_of(dqn)
    random_seat = tarena.SeatPolicy("random")
    arena = tarena.make_arena(CFG, (policy,) + (random_seat,) * 3, G, device="cpu")
    return lambda: arena((params, None, None, None), (0.0,) * 4, torch.Generator().manual_seed(11))


def _train_step():
    """One REINFORCE step (the fused rollout and loss, Adam) from fixed weights and draws."""
    spec = MLPSpec(CFG.state_length + 1, hidden_sizes=(16,), head_sizes=(1,))
    params = mlp_init(torch.Generator().manual_seed(0), spec, "cpu")
    adam = Adam(1e-3)
    step = make_reinforce_train_step(CFG, spec, adam, G, device="cpu")
    return lambda: step(params, adam.init(params), torch.Generator().manual_seed(5))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_span_without_a_profiler_is_one_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    a, b = span("engine.step"), span("nets.q")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    assert span("engine.step") is a


def test_span_under_the_profiler_is_a_recorded_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = span("nets.q")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.ones(3).add_(1)
    assert _spans(prof) == Counter({"nets.q": 1})


def test_arena_match_records_the_engine_net_and_seat_spans():
    _, spans = _profiled(_arena())
    assert spans == Counter({"engine.deal": 1, "engine.observe": 10, "engine.step": 10, "arena.seat.dqn": 10,
                             "arena.seat.random": 30, "nets.q": 10})


def test_reinforce_step_records_the_engine_and_policy_spans_inside_its_phases():
    _, spans = _profiled(_train_step())
    assert spans == Counter({"engine.deal": 1, "engine.observe": 10, "engine.step": 10, "nets.policy": 10,
                             "reinforce.rollout": 1, "reinforce.backward": 1, "reinforce.adam": 1})


def test_arena_scores_are_the_same_with_the_profiler_on_and_off():
    match = _arena()
    traced, _ = _profiled(match)
    assert torch.equal(traced, match())


def test_reinforce_step_is_the_same_with_the_profiler_on_and_off():
    step = _train_step()
    (p_on, _, m_on), _ = _profiled(step)
    p_off, _, m_off = step()
    assert torch.equal(m_on["loss"], m_off["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p_on), tree_leaves(p_off)))
