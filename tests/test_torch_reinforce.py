"""REINFORCE on the port against the JAX package: returns, the episode loss,
the self-play rollout, the train step in both ``fused_grad`` modes, the host
agents and the search agents' self-imitation learn.

The JAX functions draw from threefry keys, which the port cannot replay, so
the tests rebuild the numbers a JAX call consumes with ``jax.random`` in its
split order (``key, deal_key = split(key)``, the decks
``permutation(split(deal_key, G))``, then per turn ``key, sub = split(key)``
and ``gumbel(sub, (G, P, H))``: ``categorical`` is the argmax of logits plus
that noise) and inject them as a ``RolloutRandomness``.

Tolerances (``PARITY_TORCH.md`` sections 7 and 13): trajectories bit for bit;
float32 values rtol 1e-5, atol 1e-6 times the largest magnitude.  Parameters
after an update are compared under SGD (``optax.sgd`` / the port's ``Sgd``),
as the JAX package's own fused-vs-recompute test does: Adam's first step moves
a parameter by about ``lr`` whatever its gradient's size, and the policy
head's bias has a zero gradient by construction (the softmax is
shift-invariant), so each side steps it by the sign of its own round-off.
Under Adam the losses are compared.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from rl6nimmt_tpu.agents import mcs as jmcs
from rl6nimmt_tpu.agents import reinforce as jrf
from rl6nimmt_tpu.engine import EnvConfig as JaxConfig
from rl6nimmt_tpu.nets import MLPSpec as JMLPSpec
from rl6nimmt_tpu.nets import mlp_init as jmlp_init
from rl6nimmt_tpu.runtime import vector as jvec
from rl6nimmt_tpu.utils.returns import discounted_returns as j_discounted_returns
from rl6nimmt_torch.agents import acer as tacer
from rl6nimmt_torch.agents import mcs as tmcs
from rl6nimmt_torch.agents import reinforce as trf
from rl6nimmt_torch.agents.dqn import Adam, Sgd, tree_leaves
from rl6nimmt_torch.engine import EnvConfig
from rl6nimmt_torch.nets import MLPSpec, params_from_jax, params_to_numpy
from rl6nimmt_torch.runtime import vector as tvec
from rl6nimmt_torch.runtime.host_loop import play_games
from rl6nimmt_torch.utils.returns import discounted_returns

RTOL, ATOL = 1e-5, 1e-6
G, HIDDEN = 8, (16, 16)
JCFG, CFG = JaxConfig(4), EnvConfig(4)


def assert_f32_close(actual, desired, err_msg=""):
    """PARITY_TORCH.md section 7: rtol 1e-5, atol 1e-6 times the largest magnitude."""
    desired = np.asarray(desired)
    scale = max(1.0, float(np.abs(desired).max())) if desired.size else 1.0
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=RTOL, atol=ATOL * scale, err_msg=err_msg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_params(tp, jp, what):
    for a, b in zip(jax.tree.leaves(params_to_numpy(tp)), jax.tree.leaves(_np(jp))):
        assert_f32_close(a, b, err_msg=what)


def _specs(heads=(1,), hidden=HIDDEN):
    return (JMLPSpec(JCFG.state_length + 1, hidden_sizes=hidden, head_sizes=heads),
            MLPSpec(CFG.state_length + 1, hidden_sizes=hidden, head_sizes=heads))


def replay_rollout(key, num_games, cfg=JCFG):
    """The decks and Gumbel noise one JAX REINFORCE or ACER rollout draws from ``key``."""
    key, deal_key = jax.random.split(key)
    decks = jax.vmap(lambda k: jax.random.permutation(k, cfg.num_cards))(jax.random.split(deal_key, num_games))
    gumbel = []
    for _ in range(cfg.max_turns):
        key, sub = jax.random.split(key)
        gumbel.append(np.asarray(jax.random.gumbel(sub, (num_games, cfg.num_players, cfg.hand_size))))
    return tvec.RolloutRandomness(gumbel=torch.tensor(np.stack(gumbel)), decks=torch.tensor(np.asarray(decks)))


# ------------------------------------------------------------------ math


def test_discounted_returns_matches_jax():
    rng = np.random.RandomState(0)
    rewards = rng.randint(-12, 1, size=(10, 3, 4)).astype(np.float32)
    got = discounted_returns(torch.from_numpy(rewards), 0.99).numpy()
    want = np.stack([np.asarray(j_discounted_returns(rewards[:, i, j], 0.99))
                     for i in range(3) for j in range(4)], axis=1).reshape(10, 3, 4)
    assert_f32_close(got, want)
    np.testing.assert_array_equal(discounted_returns(torch.from_numpy(rewards), 1.0).numpy(),
                                  np.cumsum(rewards[::-1], axis=0)[::-1])


def test_reinforce_loss_matches_numpy_and_jax():
    """Mirrors tests/test_learn_steps.py::test_reinforce_episode_loss_matches_numpy."""
    jspec, tspec = _specs(hidden=(16,))
    jparams = jmlp_init(jax.random.key(7), jspec)
    tparams = params_from_jax(_np(jparams), "cpu")
    T, gamma = 5, 0.99
    rng = np.random.RandomState(3)
    batch = {"state": rng.randn(T, 47).astype(np.float32) * 10,
             "legal_cards": np.sort(rng.choice(104, size=(T, 10), replace=False).astype(np.int32), axis=1),
             "chosen": rng.randint(0, 10, T).astype(np.int32),
             "reward": rng.randn(T).astype(np.float32)}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, (actor, ent) = trf.reinforce_loss(
        lambda p, b: trf.action_in_input_logits(tspec, p, b["state"], b["legal_cards"]), tparams, tbatch,
        gamma, 1.0, 0.5)
    jfn = lambda p, b: jax.vmap(lambda s, c: jrf.action_in_input_logits(jspec, p, s, c))(b["state"], b["legal_cards"])
    jloss, (jactor, jent) = jrf.reinforce_loss(jfn, jparams, batch, gamma, 1.0, 0.5)
    for a, b in ((loss, jloss), (actor, jactor), (ent, jent)):
        assert_f32_close(a.numpy(), b)

    logits = trf.action_in_input_logits(tspec, tparams, tbatch["state"], tbatch["legal_cards"]).double().numpy()
    m = logits.max(1, keepdims=True)
    logp = logits - (m + np.log(np.exp(logits - m).sum(1, keepdims=True)))
    p = np.exp(logp)
    returns, g = np.zeros(T), 0.0
    for t in reversed(range(T)):
        g = batch["reward"][t] + gamma * g
        returns[t] = g
    want_actor = -np.sum(gamma ** np.arange(T) * returns * logp[np.arange(T), batch["chosen"]])
    want_ent = -np.sum(-(p * np.where(p > 0, logp, 0)).sum(1))
    np.testing.assert_allclose(float(actor), want_actor, rtol=1e-5)
    np.testing.assert_allclose(float(ent), want_ent, rtol=1e-5)
    np.testing.assert_allclose(float(loss), want_actor + 0.5 * want_ent, rtol=1e-5)


# --------------------------------------------------------------- rollouts


def test_reinforce_rollout_bit_exact_and_folds_one_seat_per_row():
    jspec, tspec = _specs()
    jparams = jmlp_init(jax.random.key(52), jspec)
    key = jax.random.key(53)
    jtraj, jscores = jax.jit(jvec.make_reinforce_rollout(JCFG, jspec, G))(jparams, key)
    traj, scores = tvec.make_reinforce_rollout(CFG, tspec, G, device="cpu")(
        params_from_jax(_np(jparams), "cpu"), replay_rollout(key, G))
    for name in ("obs", "legal_cards", "chosen", "reward"):
        np.testing.assert_array_equal(getattr(traj, name).numpy(), np.asarray(getattr(jtraj, name)), err_msg=name)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    # The fold [T, G, P] -> [G*P, T]: row g*P + p is seat (g, p)'s episode in time order.
    P, T = CFG.num_players, CFG.max_turns
    rewards = tvec._fold(traj.reward, G, CFG).numpy()
    np.testing.assert_array_equal(rewards.reshape(G, P, T).sum(axis=2), scores.numpy())
    legal = (tvec._fold(traj.legal_cards, G, CFG).numpy() >= 0).sum(axis=2)
    np.testing.assert_array_equal(legal, np.tile(np.arange(T, 0, -1), (G * P, 1)))


# ------------------------------------------------------------- train step


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "recompute"])
def test_reinforce_train_step_matches_jax(fused, opt):
    """Two steps on replayed keys: loss and mean_score each step; params
    after the SGD steps (module docstring)."""
    jspec, tspec = _specs()
    jopt, topt = (optax.sgd(1e-2), Sgd(1e-2)) if opt == "sgd" else (optax.adam(1e-3), Adam(1e-3))
    jparams = jmlp_init(jax.random.key(60), jspec)
    jstate = jopt.init(jparams)
    tparams = params_from_jax(_np(jparams), "cpu")
    tstate = topt.init(tparams)
    jstep = jvec.make_reinforce_train_step(JCFG, jspec, jopt, G, fused_grad=fused)
    tstep = tvec.make_reinforce_train_step(CFG, tspec, topt, G, fused_grad=fused, device="cpu")
    for i, key in enumerate(jax.random.split(jax.random.key(61), 2)):
        jparams, jstate, jm = jstep(jparams, jstate, key)
        tparams, tstate, tm = tstep(tparams, tstate, replay_rollout(key, G))
        assert float(tm["mean_score"]) == float(jm["mean_score"])   # the same games were played
        assert_f32_close(tm["loss"].numpy(), jm["loss"], f"loss {i}")
        if opt == "sgd":
            _assert_params(tparams, jparams, f"params {i}")


def test_port_fused_step_matches_port_recompute_step():
    """Mirrors tests/test_vector_runtime.py::test_reinforce_fused_grad_matches_recompute_path."""
    _, tspec = _specs(hidden=(16,))
    from rl6nimmt_torch.nets import mlp_init

    params = mlp_init(torch.Generator().manual_seed(60), tspec, "cpu")
    rnd = tvec.draw_rollout_randomness(CFG, G, torch.Generator().manual_seed(61))
    opt = Sgd(1e-2)
    outs = [tvec.make_reinforce_train_step(CFG, tspec, opt, G, fused_grad=f, device="cpu")(params, None, rnd)
            for f in (False, True)]
    (p1, _, m1), (p2, _, m2) = outs
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-6)
    assert float(m1["mean_score"]) == float(m2["mean_score"])   # identical trajectories
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


def test_reinforce_step_from_a_generator_is_deterministic():
    _, tspec = _specs()
    from rl6nimmt_torch.nets import mlp_init

    params = mlp_init(torch.Generator().manual_seed(0), tspec, "cpu")
    step = tvec.make_reinforce_train_step(CFG, tspec, Adam(1e-3), G, device="cpu")
    outs = [step(params, Adam(1e-3).init(params), torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(outs[0][2]["loss"], outs[1][2]["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])))
    assert float(outs[0][2]["mean_score"]) < 0


def test_injected_randomness_of_the_wrong_shape_raises():
    _, tspec = _specs()
    from rl6nimmt_torch.nets import mlp_init

    params = mlp_init(torch.Generator().manual_seed(0), tspec, "cpu")
    rollout = tvec.make_reinforce_rollout(CFG, tspec, G, device="cpu")
    rnd = tvec.draw_rollout_randomness(CFG, G, torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="gumbel"):
        rollout(params, tvec.RolloutRandomness(gumbel=rnd.gumbel[:, :4], deal_seed=0))
    with pytest.raises(ValueError, match="decks"):
        rollout(params, tvec.RolloutRandomness(gumbel=rnd.gumbel, decks=torch.zeros((G, 100), dtype=torch.int32)))


def test_unported_options_raise(tmp_path):
    """``axis_name`` (data parallel, ROADMAP queue 1 item 11) is ported: over a
    one-rank gloo group the REINFORCE step and the ACER cycle (both of its
    train steps) average over that one rank and equal the plain ones bit for
    bit."""
    import torch.distributed as dist

    from rl6nimmt_torch.buffers import seq_init
    from rl6nimmt_torch.nets import mlp_init

    _, tspec = _specs()
    _, aspec = _specs(heads=(1, 1))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        params = mlp_init(torch.Generator().manual_seed(0), tspec, "cpu")
        aparams = mlp_init(torch.Generator().manual_seed(1), aspec, "cpu")
        outs = []
        for axis in (None, group):
            step = tvec.make_reinforce_train_step(CFG, tspec, Adam(), G, axis_name=axis, device="cpu")
            cycle = tvec.make_acer_selfplay_step(CFG, aspec, Adam(), G, minibatch=8, on_policy_sequences=None,
                                                 axis_name=axis, device="cpu")
            buf = seq_init(64, CFG.max_turns, tvec.acer_sequence_example(CFG), device="cpu")
            p, _, m = step(params, Adam().init(params), torch.Generator().manual_seed(2))
            ap, _, _, am = cycle(aparams, Adam().init(aparams), buf, torch.Generator().manual_seed(3))
            outs.append(tree_leaves(p) + list(m.values()) + tree_leaves(ap) + list(am.values()))
        assert len(outs[0]) == len(outs[1])
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- host agents


def _episode(rng, masked, T=10):
    """One recorded episode of step records and lagged rewards."""
    recs = []
    for t in range(T):
        hand = np.sort(rng.choice(104, size=T - t, replace=False)).astype(np.int32)
        rec = {"state": rng.randint(-1, 104, size=47).astype(np.float32)}
        idx = rng.randint(0, T - t)
        if masked:
            mask = np.zeros(104, bool)
            mask[hand] = True
            rec.update(legal_mask=mask, chosen=np.int32(hand[idx]))
        else:
            padded = np.full(10, -1, np.int32)
            padded[: T - t] = hand
            rec.update(legal_cards=padded, chosen=np.int32(idx))
        recs.append((rec, -float(rng.randint(0, 8)) if t else 0.0))
    return recs


def _feed(agent, episode, num_episode=0):
    out = None
    for t, (rec, reward) in enumerate(episode):
        end = t == len(episode) - 1
        out = agent.learn(rec["state"], reward, 0, end, rec["state"], 0.0, end, num_episode,
                          step_record={k: v.copy() for k, v in rec.items()})
    return out


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("name", ["masked", "batched"])
def test_host_reinforce_agent_learn_matches_jax(name, opt):
    """Mirrors tests/test_agents.py::test_reinforce_agents_learn on recorded
    episodes: under SGD the losses of two episodes and the params after each;
    under Adam the first episode's losses (its second would start from
    parameters that Adam moved by about lr along round-off: with 10 steps of
    data many gradient entries of the shared state path are zero up to
    round-off, 1e-7, here)."""
    jcls, tcls = {"masked": (jrf.MaskedReinforceAgent, trf.MaskedReinforceAgent),
                  "batched": (jrf.BatchedReinforceAgent, trf.BatchedReinforceAgent)}[name]
    kw = dict(hidden_sizes=HIDDEN, r_factor=0.5, entropy_weight=0.1, seed=3)
    jagent, tagent = jcls(**kw), tcls(device="cpu", **kw)
    tagent.set_parameters(params_from_jax(_np(jagent.parameters()), "cpu"))
    jagent.train()
    tagent.train()
    if opt == "sgd":
        jagent.optimizer, tagent.optimizer = optax.sgd(1e-2), Sgd(1e-2)
        jagent.opt_state, tagent.opt_state = jagent.optimizer.init(jagent.params), None
        jagent._train_step = jax.jit(jagent._make_train_step())
    rng = np.random.RandomState(11)
    for e in range(2):
        episode = _episode(rng, masked=name == "masked")
        jl, tl = _feed(jagent, episode, e), _feed(tagent, episode, e)
        assert np.isfinite(tl).all() and tl[1] == 0.0
        if opt == "sgd" or e == 0:
            assert_f32_close(tl, jl, f"losses episode {e}")
        if opt == "sgd":
            _assert_params(tagent.parameters(), jagent.parameters(), f"params episode {e}")
    # forward: the same logits, a legal action and its record
    rec = episode[3][0]
    legal = list(np.flatnonzero(rec["legal_mask"])) if name == "masked" else [c for c in rec["legal_cards"] if c >= 0]
    action, info = tagent.forward(rec["state"], legal)
    _, jinfo = jagent.forward(rec["state"], legal)
    assert action in legal and info["step_record"]["chosen"].dtype == np.int32
    np.testing.assert_allclose(info["entropy"], jinfo["entropy"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("name", ["policy_mcs", "puct", "puct_customed"])
def test_search_agent_learn_matches_jax(name, opt):
    """The self-imitation learn of PolicyMCS / PUCT and PUCTCustomed's value +
    imitation learn on one recorded episode: the loss, and the params (SGD)."""
    jcls, tcls = {"policy_mcs": (jmcs.PolicyMCSAgent, tmcs.PolicyMCSAgent), "puct": (jmcs.PUCTAgent, tmcs.PUCTAgent),
                  "puct_customed": (jmcs.PUCTCustomedAgent, tmcs.PUCTCustomedAgent)}[name]
    jagent, tagent = jcls(hidden_sizes=HIDDEN, seed=4), tcls(hidden_sizes=HIDDEN, seed=4, device="cpu")
    tagent.set_parameters(params_from_jax(_np(jagent.parameters()), "cpu"))
    jagent.train()
    tagent.train()
    if opt == "sgd":
        jagent.optimizer, tagent.optimizer = optax.sgd(1e-2), Sgd(1e-2)
        jagent.opt_state, tagent.opt_state = jagent.optimizer.init(jagent.params), None
        jagent._train_step = jax.jit(jagent._make_train_step())
    episode = _episode(np.random.RandomState(12), masked=False)
    jl, tl = _feed(jagent, episode), _feed(tagent, episode)
    assert isinstance(tl, float)
    assert_f32_close(tl, jl)
    if opt == "sgd":
        _assert_params(tagent.parameters(), jagent.parameters(), name)


def test_host_agents_learn_in_host_games():
    """Mirrors tests/test_agents.py: every learning host agent changes its
    params over a few games of the port's host loop (ACER past its warmup)."""
    agents = [trf.BatchedReinforceAgent(seed=1, hidden_sizes=HIDDEN, device="cpu"),
              trf.MaskedReinforceAgent(seed=2, hidden_sizes=HIDDEN, device="cpu"),
              tacer.BatchedACERAgent(seed=3, warmup=2, minibatch=2, hidden_sizes=HIDDEN, device="cpu"),
              tmcs.PUCTAgent(seed=4, mc_max=8, mc_per_card=2, batch_playouts=4, hidden_sizes=HIDDEN, device="cpu")]
    before = [[x.clone() for x in tree_leaves(a.parameters())] for a in agents]
    for a in agents:
        a.train()
    results = play_games(agents, num_games=4, seed=5, device="cpu")
    assert results.shape == (4, 4) and (results <= 0).all() and (results.sum(axis=1) < 0).all()
    for a, b in zip(agents, before):
        assert any(not torch.equal(x, y) for x, y in zip(tree_leaves(a.parameters()), b)), type(a).__name__
    customed = tmcs.PUCTCustomedAgent(seed=5, hidden_sizes=HIDDEN, device="cpu")
    before = [x.clone() for x in tree_leaves(customed.parameters())]
    customed.train()
    play_games([customed, tmcs.MCSAgent(seed=6, mc_max=4, device="cpu")], num_games=1, device="cpu")
    assert any(not torch.equal(x, y) for x, y in zip(tree_leaves(customed.parameters()), before))
