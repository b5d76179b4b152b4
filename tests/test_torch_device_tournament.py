"""The port's device-block tournament against the JAX package.

* Each learner family's decision (``learner_decide``) equals JAX's
  ``_make_learner_decide`` on converted weights, given the draws JAX takes
  from ``fold_in(seat key, 1..3)`` rebuilt as the port's noise.
* A whole block against JAX's: ``tests/test_torch_device_block.py``.
* Eligibility equals JAX's on counterpart agents; the learn stream follows
  the GameSession protocol; ``mesh`` checks its device, ``device_learning`` runs (the
  session, ``play_device_block`` and both CLI flags); and the three decisions of ``PARITY_TORCH.md`` section 14 (single-round cap, PUCT
  gated on the session's K, K configurable).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import rl6nimmt_tpu.agents as jag
import rl6nimmt_tpu.runtime.device_tournament as jdt
from rl6nimmt_tpu.engine.state import EnvConfig as JEnvConfig
from rl6nimmt_torch import agents as tag
from rl6nimmt_torch.engine import EnvConfig, init_from_deck, observe, step
from rl6nimmt_torch.nets import MLPSpec, params_from_jax
from rl6nimmt_torch.runtime import device_tournament as tdt
from rl6nimmt_torch.tournament import Tournament
from torch_jax_noise import learner_noise

C, H = 104, 10
HID = (16,)


def _jnp(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------- learner decisions


def _positions(P, N, seed):
    """N seat views (hand, observation) after a few random turns on the port's engine."""
    cfg = EnvConfig(P)
    rng = np.random.RandomState(seed)
    state = init_from_deck(cfg, torch.from_numpy(np.stack([rng.permutation(C) for _ in range(N)])))
    for _ in range(int(rng.randint(0, 8))):
        acts = [[rng.choice([c for c in hand if c >= 0]) for hand in game] for game in state.hands_sorted.tolist()]
        state, _ = step(cfg, state, torch.tensor(acts, dtype=torch.int32))
    obs = observe(cfg, state)[0][:, 0]
    return state.hands_sorted[:, 0].numpy(), obs.numpy()


FAMILIES = {
    "noisy_dqn": lambda: jag.Noisy_D3QN(seed=1, hidden_sizes=HID),
    "dqn": lambda: jag.DuellingDQNAgent(seed=2, hidden_sizes=HID),
    "acer": lambda: jag.BatchedACERAgent(seed=3, hidden_sizes=HID),
    "rai": lambda: jag.BatchedReinforceAgent(seed=4, hidden_sizes=HID),
    "rmask": lambda: jag.MaskedReinforceAgent(seed=5, hidden_sizes=HID),
    "pv": lambda: jag.PUCTCustomedAgent(seed=6, hidden_sizes=HID),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_learner_decision_equals_jax(family):
    P, N = 4, 24
    agent = FAMILIES[family]()
    role, jslot = jdt.seat_slot(agent)
    assert role == "learner"
    tslot = tdt.LearnerSlot(jslot.family, tag_spec(jslot.spec))
    hand, obs = _positions(P, N, seed=len(family))
    eps = np.where(np.arange(N) % 2 == 0, 0.5, 0.0).astype(np.float32) if family == "dqn" else np.zeros(N, np.float32)
    keys = jax.random.split(jax.random.key(11), N)
    jdecide = jdt._make_learner_decide(JEnvConfig(P), (jslot,))
    jfn = jax.jit(jax.vmap(lambda h, o, e, k: jdecide((agent.params,), tdt.KIND_LEARNER_BASE, h, o, e, k)))
    jpick, jlogp, jvec = jfn(hand, obs, eps, keys)
    ln = learner_noise(keys, N, 1, (jslot,), (tslot,))
    draws = SimpleNamespace(**{k: (getattr(ln, k)[:, 0] if k != "q" else [{kk: v[:, 0] for kk, v in l.items()}
                                                                      for l in ln.q[tslot]])
                          for k in tdt._learner_needs(tslot)})
    tpick, tlogp, tvec = tdt.learner_decide(EnvConfig(P), tslot, params_from_jax(_jnp(agent.params), "cpu"),
                                            torch.from_numpy(hand), torch.from_numpy(obs), torch.from_numpy(eps), draws)
    np.testing.assert_array_equal(tpick.numpy(), np.asarray(jpick))
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tvec.numpy(), np.asarray(jvec), rtol=1e-5, atol=1e-6)
    if family == "dqn":   # both branches of epsilon-greedy were taken
        explore = np.asarray(draws.explore) <= eps
        assert explore.any() and (~explore).any()


def tag_spec(jspec):
    return MLPSpec(jspec.input_size, tuple(jspec.hidden_sizes), tuple(jspec.head_sizes), jspec.noisy,
                   jspec.sigma_init, jspec.activation)


# -------------------------------------------------------------- eligibility


def test_eligibility_equals_jax():
    pairs = [
        (jag.DrunkHamster(seed=0), tag.DrunkHamster(seed=0, device="cpu")),
        (jag.MCSAgent(seed=0, mc_max=4), tag.MCSAgent(seed=0, mc_max=4, device="cpu")),
        (jag.MCSAgent(seed=0, mc_max=4, batch_playouts=2), tag.MCSAgent(seed=0, mc_max=4, batch_playouts=2,
                                                                        device="cpu")),
        (jag.PolicyMCSAgent(seed=0, mc_max=4), tag.PolicyMCSAgent(seed=0, mc_max=4, device="cpu")),
        (jag.PUCTAgent(seed=0, mc_max=4), tag.PUCTAgent(seed=0, mc_max=4, device="cpu")),
        (jag.PUCTAgent(seed=0, mc_max=4, temperature=1.0), tag.PUCTAgent(seed=0, mc_max=4, temperature=1.0,
                                                                         device="cpu")),
        (jag.PUCTAgent(seed=0, mc_max=4, batch_playouts=1), tag.PUCTAgent(seed=0, mc_max=4, batch_playouts=1,
                                                                          device="cpu")),
        (jag.PUCTUniformAgent(seed=0, mc_max=4), tag.PUCTUniformAgent(seed=0, mc_max=4, device="cpu")),
        (jag.PUCTCustomedAgent(seed=0), tag.PUCTCustomedAgent(seed=0, device="cpu")),
        (jag.Noisy_D3QN_PRB_NStep(seed=0), tag.Noisy_D3QN_PRB_NStep(seed=0, device="cpu")),
        (jag.DQNVanilla(seed=0), tag.DQNVanilla(seed=0, device="cpu")),
        (jag.BatchedACERAgent(seed=0), tag.BatchedACERAgent(seed=0, device="cpu")),
        (jag.BatchedACERAgent(seed=0, max_num_actions=12), tag.BatchedACERAgent(seed=0, max_num_actions=12,
                                                                                 device="cpu")),
        (jag.BatchedActionValueActorCriticAgent(seed=0), tag.BatchedActionValueActorCriticAgent(seed=0, device="cpu")),
        (jag.BatchedReinforceAgent(seed=0), tag.BatchedReinforceAgent(seed=0, device="cpu")),
        (jag.MaskedReinforceAgent(seed=0), tag.MaskedReinforceAgent(seed=0, device="cpu")),
        (jag.Human(), tag.Human(device="cpu")),
    ]
    describe = lambda r: None if r is None else (r[0], r[1] if r[0] == "search" else r[1].family)
    for j, t in pairs:
        assert describe(tdt.seat_slot(t)) == describe(jdt.seat_slot(j)), type(t).__name__
        assert tdt.seat_kind(t) == jdt.seat_kind(j), type(t).__name__
    for a in range(len(pairs)):
        for b in range(a + 1, len(pairs)):
            for c in (b + 1,):
                lineup = [a, b] + ([c] if c < len(pairs) else [])
                jl, tl = [pairs[i][0] for i in lineup], [pairs[i][1] for i in lineup]
                assert tdt.device_lineup_eligible(tl) == jdt.device_lineup_eligible(jl)
                jsig, tsig = jdt.lineup_signature(jl), tdt.lineup_signature(tl)
                if jsig is not None:
                    fields = ("num_players", "num_rows", "num_cards", "threshold", "include_summaries", "hand_size")
                    assert [getattr(tsig[0], f) for f in fields] == [getattr(jsig[0], f) for f in fields]
                    assert (tsig[1] is None) == (jsig[1] is None)
                    assert sorted(s.family for s in tsig[2]) == sorted(s.family for s in jsig[2])
                    assert tdt.lineup_fastclass(tl) == jdt.lineup_fastclass(jl)


# ----------------------------------------------------------------- protocol


class RecordingHamster(tag.DrunkHamster):
    """An eligible random seat that records its learn argument stream."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.calls = []

    def learn(self, **kwargs):
        self.calls.append(kwargs)
        return 0.0


def test_learn_stream_follows_gamesession_protocol():
    np.random.seed(0)
    rec = RecordingHamster(seed=1, device="cpu")
    mcs = tag.MCSAgent(seed=2, mc_max=8, mc_per_card=2, device="cpu")
    (scores,) = tdt.DeviceBlockSession([[rec, mcs, tag.DrunkHamster(seed=3, device="cpu")]], device="cpu").play()
    assert len(rec.calls) == 10
    assert rec.calls[0]["reward"] == 0  # reward lag (play.py:29-72)
    for t, call in enumerate(rec.calls):
        assert call["num_episode"] == 0
        assert call["episode_end"] == call["done"] == (t == 9)
        assert len(call["legal_actions"]) == 10 - t
        assert call["action"] in call["legal_actions"]
        if t > 0:
            assert call["reward"] == rec.calls[t - 1]["next_reward"]
        if t < 9:
            np.testing.assert_array_equal(call["next_state"], rec.calls[t + 1]["state"])
            assert call["next_legal_actions"] == rec.calls[t + 1]["legal_actions"]
        else:
            assert call["next_legal_actions"] == []
    assert sum(int(c["next_reward"]) for c in rec.calls) == int(scores[0])
    assert all(s <= 0 for s in scores)


def test_unported_options_raise():
    """``mesh`` (ROADMAP queue 1 item 11) is ported: a mesh on another device
    than the session's raises before any game (``tests/test_torch_parallel.py``
    plays sharded blocks over gloo ranks); ``device_learning`` is ported (item
    10): the session and ``play_device_block`` accept it."""
    lineup = [[tag.DrunkHamster(seed=0, device="cpu"), tag.DrunkHamster(seed=1, device="cpu")]]
    card_mesh = SimpleNamespace(device=torch.device("cuda"), size=1)
    with pytest.raises(ValueError, match="mesh"):
        tdt.DeviceBlockSession(lineup, mesh=card_mesh, device="cpu")
    t = Tournament(device="cpu")
    t.add_player("a", lineup[0][0])
    t.add_player("b", lineup[0][1])
    with pytest.raises(ValueError, match="mesh"):
        t.play_device_block(2, mesh=card_mesh)
    assert t.total_games == 0
    dqn = tag.DQNVanilla(seed=2, minibatch=4, hidden_sizes=HID, device="cpu")
    dqn.train()
    np.random.seed(1)
    (scores,) = tdt.DeviceBlockSession([[dqn, lineup[0][0]]], device_learning=True, device="cpu").play()
    assert scores.shape == (2,) and dqn._device_replay["size"] == 10 and len(dqn.history) == 0
    t.add_player("dqn", dqn)
    t.play_device_block(2, device_learning=True)
    assert t.total_games == 2 and dqn._device_replay["size"] == 10 + 10 * t.played_games["dqn"]


def test_device_learning_keeps_learners_off_the_host_blocks():
    """A device-learned agent must not also learn through the host block driver:
    a learner in a lineup without a device decision is refused (JAX's assertion)."""
    np.random.seed(2)
    t = Tournament(min_players=2, max_players=2, device="cpu")
    t.add_player("human", tag.Human(device="cpu"))
    dqn = tag.DQNVanilla(seed=3, hidden_sizes=HID, device="cpu")
    dqn.train()
    t.add_player("dqn", dqn)
    with pytest.raises(AssertionError, match="learner routed to a host lineup"):
        t.play_device_block(1, device_learning=True)


def test_cli_device_learning_flags(tmp_path):
    """Both entry points' ``--device-learning`` at a tiny size on the CPU."""
    from rl6nimmt_torch.cli import run as cli_run
    from rl6nimmt_torch.experiments import simple_tournament

    t = cli_run.main(["--agents", "random", "dqn", "reinforce", "acer", "--games", "4", "--block", "4",
                      "--device-blocks", "--device-learning", "--max-players", "3", "--device", "cpu"])
    assert t.total_games == 4
    for name in ("dqn", "reinforce", "acer"):
        agent = t.agents[name]
        if t.played_games[name]:
            assert agent.opt_state is not None
            if name != "reinforce":
                assert agent._device_replay["size"] > 0 and len(agent.history) == 0
    assert t.agents["reinforce"].opt_state.count == t.played_games["reinforce"]
    t = simple_tournament.main(["--scale", "0.001", "--mc-max", "2", "--device-blocks", "--block", "2",
                                "--device-learning", "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    assert t.total_games == 7
    d3qn = [a for n, a in t.agents.items() if n.startswith("D3QN") and t.played_games[n]]
    assert d3qn and all(a._device_replay["size"] > 0 and len(a.history) == 0 for a in d3qn)


# ---------------------------------------------- PARITY_TORCH.md section 14


def test_single_round_cap_caps_the_puct_free_width():
    """(a) A PUCT-free block runs its playouts in rounds of at most the cap:
    mc_max 300 (pow2 ceiling 512) is two rounds of 256 by default, one of 512
    uncapped; a capped block plays every playout all the same."""
    mcs = tag.MCSAgent(seed=1, mc_max=300, mc_per_card=100, device="cpu")
    lineup = [[mcs, tag.DrunkHamster(seed=2, device="cpu")]]
    default = tdt.DeviceBlockSession(lineup, device="cpu").assemble()
    assert (default.puct_free, default.mc_ceiling, default.K) == (True, 512, tdt.SINGLE_ROUND_CAP)
    assert tdt.DeviceBlockSession(lineup, single_round_cap=1024, device="cpu").assemble().K == 512
    cfg = EnvConfig(2)
    assert tdt.turn_rounds(cfg, default.kinds, default.mc_maxes, default.mc_pers, default.K)[0] == 2
    small = tdt.DeviceBlockSession([[tag.MCSAgent(seed=1, mc_max=20, mc_per_card=10, device="cpu"),
                                     tag.DrunkHamster(seed=2, device="cpu")]], single_round_cap=8, device="cpu")
    inputs = small.assemble()
    assert inputs.K == 8 and tdt.turn_rounds(cfg, inputs.kinds, inputs.mc_maxes, inputs.mc_pers, 8)[0] == 3
    np.random.seed(3)
    (scores,) = small.play()
    assert scores.shape == (2,) and (scores <= 0).all()


def test_puct_eligibility_follows_the_session_k():
    """(b) A PUCT seat runs on the device only at its own round width."""
    rnd = tag.DrunkHamster(seed=0, device="cpu")
    puct8 = tag.PUCTAgent(seed=1, mc_max=8, device="cpu")            # batch_playouts defaults to 8
    puct32 = tag.PUCTAgent(seed=2, mc_max=8, batch_playouts=32, device="cpu")
    mcs = tag.MCSAgent(seed=3, mc_max=8, batch_playouts=2, device="cpu")
    assert tdt.DEFAULT_BATCH == 8
    assert tdt.device_lineup_eligible([rnd, puct8]) and not tdt.device_lineup_eligible([rnd, puct32])
    assert tdt.device_lineup_eligible([rnd, puct32], batch=32) and not tdt.device_lineup_eligible([rnd, puct8], 32)
    assert tdt.device_lineup_eligible([rnd, mcs], batch=32) and tdt.device_lineup_eligible([rnd, mcs])
    with pytest.raises(AssertionError, match="ineligible"):
        tdt.DeviceBlockSession([[rnd, puct8]], batch=32, device="cpu")
    # The tournament routes the other width through the host block driver.
    np.random.seed(4)
    t = Tournament(min_players=2, max_players=2, device="cpu")
    t.add_player("r", rnd)
    t.add_player("p", tag.PUCTAgent(seed=5, mc_max=4, mc_per_card=1, batch_playouts=4, device="cpu"))
    t.play_device_block(2)
    assert t.total_games == 2 and t.played_games["p"] == 2


def test_tournament_device_block_mixed_population_and_pipeline():
    """The JAX package's population test, plus evolve's clones and the
    pipelined schedule."""
    np.random.seed(7)
    t = Tournament(min_players=2, max_players=3, device="cpu")
    t.add_player("random", tag.DrunkHamster(seed=1, device="cpu"))
    t.add_player("mcs", tag.MCSAgent(seed=2, mc_max=8, mc_per_card=2, device="cpu"))
    puct = tag.PUCTAgent(seed=3, mc_max=8, mc_per_card=2, hidden_sizes=HID, device="cpu")
    puct.train()
    t.add_player("puct", puct)
    dqn = tag.DQNVanilla(seed=4, minibatch=4, device="cpu")
    dqn.train()
    t.add_player("dqn", dqn)
    t.play_device_block(6, bucket=8)
    t.evolve(max_players=6, max_per_descendant=2, copies=(2,))
    t.play_device_block(6, pipeline=True)
    assert t.total_games == 12
    for name in t.agents:
        assert len(t.elos[name]) == 1 + t.played_games[name]
    assert sum(t.played_games.values()) >= 24
    assert str(t)
