"""The port's search primitives, policy nets, playouts and host search agents
against the JAX package on the same NumPy-seeded inputs.

Exact (bit for bit): ``playout_budget``, ``factorial_table``,
``_masked_median``, ``_normalized_q``, ``puct_select``, ``deal_opponents``,
the root-state builders, ``normalize_state`` (against JAX run op by op: a
jitted XLA program contracts ``x * scale + shift`` into an FMA, within one
rounding), the uniform-rule playout returns given the Gumbel noise rebuilt
from the JAX keys, and the host agents' choices given injected playout
outcomes.  float32 net outputs: ``PARITY_TORCH.md`` section 7's tolerance
(rtol 1e-5, atol 1e-6 times the largest magnitude).  Net-rule playouts: equal
returns in at least 99 % of the playouts (their logits within that tolerance;
a near-tie of two logits can flip a sample).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl6nimmt_tpu.agents import MCSAgent as JMCSAgent
from rl6nimmt_tpu.agents import PUCTAgent as JPUCTAgent
from rl6nimmt_tpu.agents import device_search as jds
from rl6nimmt_tpu.agents import reinforce as jrf
from rl6nimmt_tpu.agents import search as jsearch
from rl6nimmt_tpu.agents.mcs import _policy_value as j_policy_value
from rl6nimmt_tpu.engine.state import EnvConfig as JEnvConfig
from rl6nimmt_tpu.nets import MLPSpec as JMLPSpec
from rl6nimmt_tpu.nets import mlp_init as jmlp_init
from rl6nimmt_tpu.nets import normalize_state as jnormalize
from rl6nimmt_torch.agents import device_search as tds
from rl6nimmt_torch.agents import reinforce as trf
from rl6nimmt_torch.agents import search as tsearch
from rl6nimmt_torch.agents.mcs import MCSAgent, PUCTAgent, PUCTCustomedAgent, _policy_value
from rl6nimmt_torch.engine import EnvConfig
from rl6nimmt_torch.nets import MLPSpec, normalize_state, params_from_jax

RTOL, ATOL = 1e-5, 1e-6


def assert_f32_close(actual, desired):
    """PARITY_TORCH.md section 7: rtol 1e-5, atol 1e-6 times the largest magnitude."""
    desired = np.asarray(desired)
    scale = max(1.0, float(np.abs(desired[np.isfinite(desired)]).max()))
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=RTOL, atol=ATOL * scale)


def _np_params(spec, seed):
    return jax.tree.map(np.asarray, jmlp_init(jax.random.key(seed), spec))


def _specs(heads=(1,), hidden=(16, 16), state_length=47):
    return (JMLPSpec(state_length + 1, hidden_sizes=hidden, head_sizes=heads),
            MLPSpec(state_length + 1, hidden_sizes=hidden, head_sizes=heads))


def _observations(rng, n):
    """``[n, 47]`` observation-like rows: hand slots, player count, summaries, board."""
    return rng.randint(-1, 104, size=(n, 47)).astype(np.float32)


def _hands(rng, n, width=10):
    """``[n, width]`` ascending card lists with a random count of ``-1`` pads."""
    out = np.full((n, width), -1, np.int32)
    for i in range(n):
        k = rng.randint(1, width + 1)
        out[i, :k] = np.sort(rng.choice(104, k, replace=False))
    return out


# ----------------------------------------------------------- random draws


def test_categorical_is_gumbel_argmax():
    """``jax.random.categorical(k, logits) == argmax(logits + gumbel(k, logits.shape))``:
    the identity the port's injected Gumbel noise rests on."""
    rng = np.random.RandomState(0)
    for shape in [(4, 3, 104), (10,)]:
        logits = jnp.asarray(np.where(rng.rand(*shape) < 0.3, -np.inf, rng.randn(*shape)).astype(np.float32))
        logits = logits.at[..., 0].set(0.0)
        for seed in range(3):
            k = jax.random.key(seed)
            want = jax.random.categorical(k, logits, axis=-1)
            got = torch.argmax(torch.from_numpy(np.asarray(logits + jax.random.gumbel(k, logits.shape))), dim=-1)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- exact pieces


@pytest.mark.parametrize("hand_size", [10, 12, 13, 20])
def test_factorial_table_exact(hand_size):
    np.testing.assert_array_equal(tds.factorial_table(hand_size, device="cpu").numpy(),
                                  np.asarray(jds.factorial_table(hand_size)))


@pytest.mark.parametrize("mc_max,mc_per", [(100, 10), (200, 10), (400, 1), (2**31 - 1, 1000), (7, 0), (1, 3)])
def test_playout_budget_exact_with_saturation(mc_max, mc_per):
    fact_j, fact_t = jds.factorial_table(13), tds.factorial_table(13, device="cpu")
    for n in range(14):
        want = int(jds.playout_budget(mc_max, mc_per, fact_j[n]))
        got = tds.playout_budget(mc_max, mc_per, fact_t[n])
        assert got.dtype == torch.int32 and int(got) == want, (n, int(got), want)


@pytest.mark.parametrize("ties", [False, True])
def test_masked_median_exact(ties):
    rng = np.random.RandomState(3 + ties)
    vals = (rng.randint(-4, 2, size=(5, 16)) if ties else rng.randn(5, 16)).astype(np.float32)
    for count in [0, 1, 2, 5, 10, 11, 16]:
        want = np.stack([np.asarray(jds._masked_median(jnp.asarray(v), count)) for v in vals])
        got = tds._masked_median(torch.from_numpy(vals), torch.full((5,), count)).numpy()
        np.testing.assert_array_equal(got, want)
        if count:
            np.testing.assert_allclose(got, np.median(vals[:, :count], axis=1), rtol=0, atol=1e-6)


OUTCOMES = [
    # cold start (< 10 outcomes: the constants 0, -10, -5)
    {3: [-2.0], 7: [], 11: [-5.0, -1.0], 20: []},
    # warm: min, max and median from 12 outcomes
    {3: [-2.0, -4.0, -1.0], 7: [-9.0, -3.0, -3.5], 11: [0.0, -6.0, -2.0], 20: [-7.0, -8.0, -0.5]},
    # every outcome equal: q = 0.5
    {3: [-4.0] * 6, 7: [-4.0] * 5, 11: [], 20: []},
    # warm, even count, an action never rolled out (q at the median)
    {3: [-1.0] * 4, 7: [-9.0] * 5, 11: [-5.0, -3.0, -3.0], 20: []},
]


def _stats(legal, outcomes, buf_len=64):
    act_sum = np.array([sum(outcomes[a]) for a in legal], np.float32)
    act_cnt = np.array([len(outcomes[a]) for a in legal], np.float32)
    flat = [r for a in legal for r in outcomes[a]]
    rets_buf = np.zeros(buf_len, np.float32)
    rets_buf[: len(flat)] = flat
    return act_sum, act_cnt, rets_buf, len(flat)


@pytest.mark.parametrize("case", range(len(OUTCOMES)))
def test_normalized_q_exact(case):
    legal = [3, 7, 11, 20]
    act_sum, act_cnt, rets_buf, completed = _stats(legal, OUTCOMES[case])
    want = np.asarray(jds._normalized_q(jnp.asarray(act_sum), jnp.asarray(act_cnt), jnp.asarray(rets_buf), completed))
    got = tds._normalized_q(*map(torch.from_numpy, (act_sum, act_cnt, rets_buf)), completed).numpy()
    np.testing.assert_array_equal(got, want)
    if case == 2:
        assert (got == 0.5).all()


@pytest.mark.parametrize("case", ["given", "pads_and_inactive", "ties"])
def test_puct_select_exact(case):
    """Per game against JAX's single-game ``puct_select``; the port runs the
    games as one batch with a per-game ``c_puct``."""
    rng = np.random.RandomState({"given": 0, "pads_and_inactive": 1, "ties": 2}[case])
    G, H, K = 6, 10, 8
    q = rng.rand(G, H).astype(np.float32)
    probs = rng.dirichlet(np.ones(H), size=G).astype(np.float32)
    cnt = rng.randint(0, 5, size=(G, H)).astype(np.float32)
    valid = np.ones((G, H), bool)
    active = np.ones((G, K), bool)
    c_puct = np.full(G, 2.0, np.float32)
    if case == "pads_and_inactive":
        valid[:, 6:] = False
        active[:, 5:] = False
        c_puct = rng.uniform(0.5, 3.0, G).astype(np.float32)
    if case == "ties":
        q[:] = 0.5
        probs[:] = 0.1
        cnt[:] = 1.0
    got = tds.puct_select(*map(torch.from_numpy, (q, probs, cnt, valid, active)), torch.from_numpy(c_puct)).numpy()
    for g in range(G):
        want = np.asarray(jds.puct_select(jnp.asarray(q[g]), jnp.asarray(probs[g]), jnp.asarray(cnt[g]),
                                          jnp.asarray(valid[g]), jnp.asarray(active[g]), c_puct[g]))
        np.testing.assert_array_equal(got[g], want)
    if case == "ties":
        assert list(got[0][:3]) == [0, 1, 2]   # equal scores: the first maximum, then pending counts


@pytest.mark.parametrize("num_opp,n", [(1, 10), (3, 7), (3, 4), (5, 1)])
def test_deal_opponents_exact(num_opp, n):
    """Given the uniforms JAX draws from its key: identical hands, ``-1`` pads past ``n``."""
    rng = np.random.RandomState(num_opp * 10 + n)
    C, slots = 104, 10
    avail = np.zeros((6, C), bool)
    for g in range(6):
        avail[g, rng.choice(C, num_opp * n + rng.randint(0, 30), replace=False)] = True
    keys = jax.random.split(jax.random.key(n), 6)
    u = np.stack([np.asarray(jax.random.uniform(k, (C,))) for k in keys])
    got = tds.deal_opponents(torch.from_numpy(avail), torch.from_numpy(u), num_opp, n, slots).numpy()
    for g in range(6):
        want = np.asarray(jds.deal_opponents(jnp.asarray(avail[g]), keys[g], num_opp, n, slots))
        np.testing.assert_array_equal(got[g], want)
    assert (got[..., n:] == -1).all() and (got[..., :n] >= 0).all()


def test_device_build_root_state_exact():
    rng = np.random.RandomState(7)
    P, H, B = 3, 10, 5
    jcfg, tcfg = JEnvConfig(P), EnvConfig(P)
    board = rng.randint(-1, 104, size=(B, 4, 6)).astype(np.int32)
    row_len = rng.randint(1, 6, size=(B, 4)).astype(np.int32)
    my_hand, opp = _hands(rng, B), np.stack([_hands(rng, P - 1) for _ in range(B)])
    got = tds.build_root_state(tcfg, *map(torch.from_numpy, (board, row_len, my_hand, opp)))
    for b in range(B):
        want = jds.build_root_state(jcfg, board[b], row_len[b], jnp.asarray(my_hand[b]), jnp.asarray(opp[b]))
        for field in ("board", "row_len", "hands", "hands_sorted", "scores", "turn"):
            np.testing.assert_array_equal(getattr(got, field)[b].numpy(), np.asarray(getattr(want, field)))


def _root_inputs(rng, G, K, P, n):
    """Boards, searcher hands and ``[G, K, P-1, n]`` opponent hands from one shuffled deck a game."""
    boards, mine, opp = [], [], np.zeros((G, K, P - 1, n), np.int64)
    for g in range(G):
        deck = rng.permutation(104)
        boards.append([list(deck[r * 3: r * 3 + 1 + r % 3]) for r in range(4)])
        mine.append(list(deck[12: 12 + n]))
        pool = deck[12 + n:]
        for k in range(K):
            opp[g, k] = rng.permutation(pool)[: (P - 1) * n].reshape(P - 1, n)
    return boards, mine, opp


def test_build_root_states_batch_exact():
    rng = np.random.RandomState(8)
    P, G, K, n = 3, 3, 4, 6
    boards, mine, opp = _root_inputs(rng, G, K, P, n)
    got = tsearch.build_root_states_batch(EnvConfig(P), boards, mine, opp, device="cpu")
    want = jsearch.build_root_states_batch(JEnvConfig(P), boards, mine, opp)
    for field in ("board", "row_len", "hands", "hands_sorted", "scores", "turn"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    one = tsearch.build_root_state(EnvConfig(P), boards[1], mine[1], opp[1], device="cpu")
    np.testing.assert_array_equal(one.hands_sorted.numpy(), got.hands_sorted[K:2 * K].numpy())


# ------------------------------------------------------------------- nets


@pytest.mark.parametrize("action", [False, True])
def test_normalize_state_exact(action):
    x = np.random.RandomState(9).randint(-1, 104, size=(32, 47 + action)).astype(np.float32)
    got = normalize_state(torch.from_numpy(x), action=action).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnormalize(x, action=action)))


@pytest.mark.parametrize("hidden", [(16,), (100, 100)])
def test_action_in_input_logits_and_heads(hidden):
    jspec, tspec = _specs(heads=(1, 2), hidden=hidden)
    p = _np_params(jspec, 1)
    tp = params_from_jax(p, "cpu")
    rng = np.random.RandomState(10)
    obs, hands = _observations(rng, 12), _hands(rng, 12)
    heads = trf.action_in_input_heads(tspec, tp, torch.from_numpy(obs), torch.from_numpy(hands))
    logits = trf.action_in_input_logits(tspec, tp, torch.from_numpy(obs), torch.from_numpy(hands)).numpy()
    jheads = jax.vmap(lambda o, h: jrf.action_in_input_heads(jspec, p, o, h))(obs, hands)
    for th, jh in zip(heads, jheads):
        assert_f32_close(th.numpy(), jh)
    jlog = jax.vmap(lambda o, h: jrf.action_in_input_logits(jspec, p, o, h))(obs, hands)
    assert_f32_close(logits, jlog)
    assert (logits[hands < 0] == trf.NEG_INF).all()


def test_masked_policy_logits_and_entropy():
    jspec = JMLPSpec(47, hidden_sizes=(16,), head_sizes=(104,))
    tspec = MLPSpec(47, hidden_sizes=(16,), head_sizes=(104,))
    p = _np_params(jspec, 2)
    rng = np.random.RandomState(11)
    obs, mask = _observations(rng, 8), rng.rand(8, 104) < 0.2
    got = trf.masked_policy_logits(tspec, params_from_jax(p, "cpu"), torch.from_numpy(obs), torch.from_numpy(mask))
    want = jrf.masked_policy_logits(jspec, p, obs, mask)
    assert_f32_close(got.numpy(), want)
    for t, j in zip(trf.log_probs_and_entropy(got), jrf.log_probs_and_entropy(want)):
        assert_f32_close(t.numpy(), j)


def test_policy_value_matches_jax():
    jspec, tspec = _specs(heads=(2,), hidden=(100, 100))
    p = _np_params(jspec, 3)
    rng = np.random.RandomState(12)
    obs, hands = _observations(rng, 6), _hands(rng, 6)
    logp, values = _policy_value(tspec, params_from_jax(p, "cpu"), torch.from_numpy(obs), torch.from_numpy(hands))
    for i in range(6):
        jl, jv = j_policy_value(jspec, p, obs[i], jnp.asarray(hands[i]))
        valid = hands[i] >= 0
        assert (np.isneginf(logp[i].numpy()) == ~valid).all() and (np.isneginf(values[i].numpy()) == ~valid).all()
        assert_f32_close(logp[i].numpy()[valid], np.asarray(jl)[valid])
        assert_f32_close(values[i].numpy()[valid], np.asarray(jv)[valid])


# --------------------------------------------------------------- playouts


def playout_gumbel(keys, n_turns, P, width):
    """The Gumbel noise JAX's playouts draw from ``keys[k]``: per turn
    ``key, sub = split(key)`` then ``gumbel(sub, (P, width))``; ``[n, K, P, width]``."""
    out = []
    for key in keys:
        per_turn = []
        for _ in range(n_turns):
            key, sub = jax.random.split(key)
            per_turn.append(np.asarray(jax.random.gumbel(sub, (P, width))))
        out.append(np.stack(per_turn))
    return np.stack(out, axis=1)


def _playout_batch(P, K, seed):
    rng = np.random.RandomState(seed)
    boards, mine, opp = _root_inputs(rng, 1, K, P, 10)
    firsts = rng.choice(mine[0], K).astype(np.int32)
    return boards[0], mine[0], opp[0], firsts


@pytest.mark.parametrize("n_turns", [1, 5, 10])
def test_uniform_playouts_bit_exact(n_turns):
    P, K = 3, 32
    board, mine, opp, firsts = _playout_batch(P, K, n_turns)
    jstates = jsearch.build_root_state(JEnvConfig(P), board, mine, opp)
    keys = jax.random.split(jax.random.key(100 + n_turns), K)
    want = np.asarray(jsearch.make_playout_fn(JEnvConfig(P), "uniform", None)(None, jstates, firsts, n_turns, keys))
    tstates = tsearch.build_root_state(EnvConfig(P), board, mine, opp, device="cpu")
    play = tsearch.make_playout_fn(EnvConfig(P), "uniform", None, device="cpu")
    got = play(None, tstates, torch.from_numpy(firsts), n_turns, torch.from_numpy(playout_gumbel(keys, n_turns, P, 104)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and (got <= 0).all()


def test_net_playouts_agree():
    P, K, n_turns = 3, 128, 6
    jspec, tspec = _specs(hidden=(16, 16))
    p = _np_params(jspec, 4)
    board, mine, opp, firsts = _playout_batch(P, K, 13)
    jstates = jsearch.build_root_state(JEnvConfig(P), board, mine, opp)
    keys = jax.random.split(jax.random.key(7), K)
    want = np.asarray(jsearch.make_playout_fn(JEnvConfig(P), "net", jspec)(p, jstates, firsts, n_turns, keys))
    tstates = tsearch.build_root_state(EnvConfig(P), board, mine, opp, device="cpu")
    tp = params_from_jax(p, "cpu")
    got = tsearch.make_playout_fn(EnvConfig(P), "net", tspec, device="cpu")(
        tp, tstates, torch.from_numpy(firsts), n_turns, torch.from_numpy(playout_gumbel(keys, n_turns, P, 10)))
    agree = float(np.mean(got.numpy() == want))
    assert agree >= 0.99, agree
    # The first turn's logits, every seat of every playout, within tolerance.
    jobs = jax.vmap(lambda s: jsearch.observe(JEnvConfig(P), s)[0])(jstates)
    jlog = jax.vmap(jax.vmap(lambda o, h: jrf.action_in_input_logits(jspec, p, o, h)))(jobs, jstates.hands_sorted)
    tobs = tsearch.observe(EnvConfig(P), tstates)[0]
    assert_f32_close(trf.action_in_input_logits(tspec, tp, tobs, tstates.hands_sorted).numpy(), jlog)


def test_make_playout_fn_draws_from_a_generator():
    P, K = 2, 16
    board, mine, opp, firsts = _playout_batch(P, K, 21)
    states = tsearch.build_root_state(EnvConfig(P), board, mine, opp, device="cpu")
    play = tsearch.make_playout_fn(EnvConfig(P), "uniform", None, device="cpu")
    a = play(None, states, torch.from_numpy(firsts), 10, torch.Generator().manual_seed(1))
    b = play(None, states, torch.from_numpy(firsts), 10, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (K,) and (a <= 0).all()
    with pytest.raises(ValueError, match="'uniform' or the 'net'"):
        tsearch.make_playout_fn(EnvConfig(P), "mixed", None, device="cpu")


# ------------------------------------------------------- host search agents


def _injected(hands_sorted, first):
    """Deterministic playout outcomes from the determinization and the first move."""
    hs = np.asarray(hands_sorted)
    return -((np.asarray(first, np.int64) * 7 + hs[:, 1, 0] + hs[:, -1, 1]) % 11).astype(np.float32)


def _host_position(P, seed):
    from rl6nimmt_torch.engine import deal, observe

    state = deal(EnvConfig(P), seed, 3, device="cpu")
    obs = observe(EnvConfig(P), state)[0][:, 0].numpy()
    legal = [[c for c in state.hands_sorted[g, 0].tolist() if c >= 0] for g in range(3)]
    return obs, legal


@pytest.mark.parametrize("kind", ["mcs", "puct"])
def test_host_search_choice_equals_jax(kind):
    """``device_root=False``: NumPy's global generator drives the roots in both
    packages, so with equal playout outcomes the choices are equal."""
    P = 3
    jenv = JEnvConfig(P)
    obs, legal = _host_position(P, 31)
    kw = dict(mc_max=24, seed=5)
    if kind == "mcs":
        jagent, tagent = JMCSAgent(env=jenv, **kw), MCSAgent(env=EnvConfig(P), device="cpu", **kw)
    else:
        jagent, tagent = JPUCTAgent(env=jenv, **kw), PUCTAgent(env=EnvConfig(P), device="cpu", **kw)
        tagent.params = params_from_jax(jax.tree.map(np.asarray, jagent.params), "cpu")
    for agent in (jagent, tagent):
        agent._run_playout_batch = lambda playout, states0, first, n: _injected(states0.hands_sorted, first)
    results = []
    for agent in (jagent, tagent):
        np.random.seed(77)
        single = agent.forward(obs[0], legal[0])
        memories = [agent.new_memory() for _ in range(3)]
        many = agent.forward_many(list(obs), legal, memories)
        results.append([single] + many)
    for (ja, jinfo), (ta, tinfo) in zip(*results):
        assert ja == ta
        assert tinfo["log_prob"] == pytest.approx(jinfo["log_prob"], rel=1e-5, abs=1e-6)
        for k in ("state", "legal_cards", "chosen"):
            np.testing.assert_array_equal(tinfo["step_record"][k], jinfo["step_record"][k])


def test_agents_serve_without_learning_and_clone():
    P = 2
    obs, legal = _host_position(P, 41)
    for cls in (MCSAgent, PUCTAgent, PUCTCustomedAgent):
        agent = cls(env=EnvConfig(P), mc_max=8, seed=1, device="cpu", device_root=True)
        action, info = agent.forward(obs[0], legal[0])
        assert action in legal[0] and info["step_record"]["chosen"] == legal[0].index(action)
        twin = agent.clone()
        assert twin.forward(obs[0], legal[0])[0] == agent.forward(obs[0], legal[0])[0]
        if cls is MCSAgent:
            assert agent.learn() is None
        else:
            # Before an episode's end a learn call only records the step.
            assert agent.learn(None, 0.0, action, False, None, 0.0, False, 0,
                               step_record=info["step_record"]) == 0.0
            agent.train()
            assert agent.opt_state is not None and agent.clone().opt_state.count == 0
    assert math.isclose(PUCTAgent(env=EnvConfig(P), seed=0, device="cpu").c_puct, 2.0)
