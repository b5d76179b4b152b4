"""The port's whole search decisions and device matches against the JAX package.

Decisions: given the noise JAX draws from its keys (rebuilt here in JAX's
split order and handed over as a ``DecisionNoise``), a kind-static decision
(roots ``uniform`` and ``puct``) and a kind-traced one (kinds 0-4 in one
block) on uniform playouts choose JAX's actions, at K = 8 and K = 32, with
the chosen log-probs within ``PARITY_TORCH.md`` section 7's tolerance (the
PUCT and policy priors come from the net, whose f32 outputs agree within it).
Matches: distribution level (the JAX match deals with threefry), plus the
port's own invariants from the JAX package's decks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl6nimmt_tpu.agents import device_search as jds
from rl6nimmt_tpu.engine.state import EnvConfig as JEnvConfig
from rl6nimmt_tpu.nets import MLPSpec as JMLPSpec
from rl6nimmt_tpu.nets import mlp_init as jmlp_init
from rl6nimmt_torch.agents import device_search as tds
from rl6nimmt_torch.engine import EnvConfig, card_points, init_from_deck, observe, step
from rl6nimmt_torch.nets import MLPSpec, mlp_init, params_from_jax
from rl6nimmt_torch.runtime.device_match import board_seen, make_device_match_fn, playout_turns_per_seat

P, C, H = 3, 104, 10
HIDDEN = (16, 16)


def _position(G, turns, seed):
    """G games of P players after ``turns`` random turns on the port's engine
    (held against the JAX engine by ``test_torch_engine.py``): seat 0's
    board, row lengths, hand, card memory and observation as numpy."""
    cfg = EnvConfig(P)
    rng = np.random.RandomState(seed)
    state = init_from_deck(cfg, torch.from_numpy(np.stack([rng.permutation(C) for _ in range(G)])))
    seen = board_seen(cfg, state)
    for _ in range(turns):
        acts = [[rng.choice([c for c in hand if c >= 0]) for hand in game] for game in state.hands_sorted.tolist()]
        state, _ = step(cfg, state, torch.tensor(acts, dtype=torch.int32))
        seen = seen | board_seen(cfg, state)
    obs = observe(cfg, state)[0][:, 0]
    avail = ~(seen | state.hands[:, 0])
    return tuple(x.numpy() for x in (state.board, state.row_len, state.hands_sorted[:, 0], avail, obs))


def _round_noise(key, K, n):
    """One game's round of JAX's decision noise: ``key, k_first, k_deal, k_play =
    split(key, 4)``; the root samples' ``gumbel(k_first, (K, H))``, one
    ``uniform(split(k_deal, K)[k], (C,))`` per determinization, and per playout
    the turn chain of ``split(k_play, K)[k]`` (uniform rule: ``key, sub =
    split(key)``, ``gumbel(sub, (P, C))``)."""
    key, k_first, k_deal, k_play = jax.random.split(key, 4)
    deal = jax.vmap(lambda k: jax.random.uniform(k, (C,)))(jax.random.split(k_deal, K))

    def chain(pk):
        def turn(pk, _):
            pk, sub = jax.random.split(pk)
            return pk, jax.random.gumbel(sub, (P, C))
        return jax.lax.scan(turn, pk, None, length=n)[1]                  # [n, P, C]

    play = jax.vmap(chain)(jax.random.split(k_play, K))                    # [K, n, P, C]
    return key, jax.random.gumbel(k_first, (K, H)), deal, play


@functools.lru_cache(maxsize=None)
def _round_noise_fn(K, n):
    return jax.jit(jax.vmap(lambda k: _round_noise(k, K, n)))


def decision_noise(keys, n_rounds, K, n, unified=False):
    """The noise JAX's decision draws from ``keys[g]``, round by round in its
    split order (:func:`_round_noise`), as a ``DecisionNoise``.  A kind-traced
    decision's random pick is ``gumbel(fold_in(key, 0), (H,))`` from the key
    after the game's own ``n_rounds[g]`` rounds."""
    G = len(keys)
    one_round = _round_noise_fn(K, n)
    rounds, finals = [], keys
    for r in range(max(n_rounds)):
        key, first, deal, play = one_round(finals)
        finals = jnp.where(jnp.asarray([r < m for m in n_rounds])[:, None], jax.random.key_data(key),
                           jax.random.key_data(finals))
        finals = jax.random.wrap_key_data(finals)
        uniform = np.asarray(play).reshape(G * K, n, P, C).transpose(1, 0, 2, 3)
        rounds.append(tds.RoundNoise(deal=torch.from_numpy(np.asarray(deal)), first=torch.from_numpy(np.asarray(first)),
                                     uniform=torch.from_numpy(np.ascontiguousarray(uniform))))
    random = None
    if unified:
        random = torch.from_numpy(np.asarray(jax.vmap(lambda k: jax.random.gumbel(jax.random.fold_in(k, 0), (H,)))(finals)))
    return tds.DecisionNoise(rounds=rounds, random=random)


def _nets(seed):
    jspec = JMLPSpec(JEnvConfig(P).state_length + 1, hidden_sizes=HIDDEN, head_sizes=(1,))
    tspec = MLPSpec(EnvConfig(P).state_length + 1, hidden_sizes=HIDDEN, head_sizes=(1,))
    jp = jax.tree.map(np.asarray, jmlp_init(jax.random.key(seed), jspec))
    return jspec, tspec, jp, params_from_jax(jp, "cpu")


# (K, mc_max): two rounds each; at K = 32 mc_max must pass 32, or one round is all (VERDICT r5 weak #3).
SCHEDULES = [(8, 16), (32, 40)]


@pytest.mark.parametrize("root", ["uniform", "puct"])
@pytest.mark.parametrize("K,mc_max", SCHEDULES)
def test_static_decision_equals_jax(root, K, mc_max):
    G, n = 7, 4
    board, row_len, hand, avail, obs = _position(G, 10 - n, seed=K + mc_max)
    jspec, tspec, jp, tp = _nets(1)
    need = root != "uniform"
    keys = jax.random.split(jax.random.key(K), G)
    jfn = jds.make_device_decision_fn_many(JEnvConfig(P), "uniform", jspec if need else None, root, mc_max, K, 2.0)
    ja, jl = jfn(jp if need else None, board, row_len, hand, n, mc_max, avail, obs, keys)
    tfn = tds.make_device_decision_fn_many(EnvConfig(P), "uniform", tspec if need else None, root, mc_max, K, 2.0,
                                           device="cpu")
    noise = decision_noise(keys, [mc_max // K + (mc_max % K > 0)] * G, K, n)
    ta, tl = tfn(tp if need else None, board, row_len, hand, n, mc_max, avail, obs, noise)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    # The statistics the choice came from: every playout counted once, on a legal slot.
    search = tds._make_search(EnvConfig(P), tspec if need else None, mc_max, K, "cpu")
    act_sum, act_cnt, _, _ = search(tp if need else None, tds._static_roots(root, "uniform", G), board, row_len, hand,
                                    n, mc_max, 2.0, avail, obs, tds._Noise(noise, "cpu"))
    assert torch.equal(torch.gather(torch.from_numpy(hand), 1, tds._best(act_sum, act_cnt)[:, None])[:, 0], ta)
    assert (act_cnt.sum(dim=1) == mc_max).all() and (act_cnt[torch.from_numpy(hand) < 0] == 0).all()
    assert (act_sum <= 0).all()


@pytest.mark.parametrize("K,mc_max", SCHEDULES)
def test_unified_decision_equals_jax(K, mc_max):
    """Kinds 0-4 in one block of uniform-playout decisions; random seats pass n_mc = 0."""
    kinds = np.array([0, 1, 2, 3, 4, 3, 1], np.int32)
    G, n = len(kinds), 4
    board, row_len, hand, avail, obs = _position(G, 10 - n, seed=K)
    jspec, tspec, jp, tp = _nets(2)
    n_mc = np.where(kinds == 0, 0, mc_max).astype(np.int32)
    c_puct = np.full(G, 2.0, np.float32)
    keys = jax.random.split(jax.random.key(K + 1), G)
    jfn = jax.jit(jax.vmap(jds._make_decide_unified(JEnvConfig(P), jspec, mc_max, K, False, True),
                           in_axes=(None, 0, 0, 0, 0, None, 0, 0, 0, 0, 0)))
    ja, jl, jpick = jfn(jp, kinds, board, row_len, hand, n, n_mc, c_puct, avail, obs, keys)
    rounds = [int(m) // K + (int(m) % K > 0) for m in n_mc]
    tfn = tds.make_unified_decision_fn(EnvConfig(P), tspec, mc_max, K, uniform_playouts=True, device="cpu")
    ta, tl, tpick = tfn(tp, torch.from_numpy(kinds), board, row_len, hand, n, torch.from_numpy(n_mc),
                        torch.from_numpy(c_puct), avail, obs, decision_noise(keys, rounds, K, n, unified=True))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tpick.numpy(), np.asarray(jpick))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)


def test_unified_equals_static_given_one_noise():
    """As in JAX: a kind-traced decision equals the kind-static one of the same
    root and playout rule on the same noise (PUCT over net playouts here)."""
    G, n, K, mc_max = 4, 3, 8, 24
    board, row_len, hand, avail, obs = _position(G, 10 - n, seed=5)
    _, tspec, _, tp = _nets(3)
    gen_state = torch.Generator().manual_seed(9).get_state()
    outs = []
    for fn, args in [
        (tds.make_device_decision_fn_many(EnvConfig(P), "net", tspec, "puct", mc_max, K, 2.0, device="cpu"), ()),
        (tds.make_unified_decision_fn(EnvConfig(P), tspec, mc_max, K, device="cpu"), (tds.KIND_PUCT,)),
    ]:
        gen = torch.Generator()
        gen.set_state(gen_state)
        if args:
            outs.append(fn(tp, *args, board, row_len, hand, n, mc_max, 2.0, avail, obs, gen)[:2])
        else:
            outs.append(fn(tp, board, row_len, hand, n, mc_max, avail, obs, gen))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_argmax_takes_the_first_maximum():
    """The choice is the first maximum of the mean outcome, as np.argmax."""
    act_sum = torch.tensor([[-4.0, -2.0, -2.0, 0.0], [-1.0, -1.0, -1.0, -1.0]])
    act_cnt = torch.tensor([[2.0, 1.0, 1.0, 0.0], [1.0, 1.0, 1.0, 1.0]])
    assert tds._best(act_sum, act_cnt).tolist() == [0, 0]


def test_decision_validation():
    _, tspec, _, _ = _nets(0)
    with pytest.raises(ValueError, match="unknown root"):
        tds.make_device_decision_fn_many(EnvConfig(P), "uniform", None, "greedy", 8, 8, 2.0, device="cpu")
    with pytest.raises(ValueError, match="needs the policy net"):
        tds.make_device_decision_fn_many(EnvConfig(P), "net", None, "uniform", 8, 8, 2.0, device="cpu")
    board, row_len, hand, avail, obs = _position(2, 2, seed=1)
    fn = tds.make_device_decision_fn_many(EnvConfig(P), "uniform", None, "uniform", 8, 8, 2.0, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        fn(None, board, row_len, hand, 8, 9, avail, obs, torch.Generator())
    single = tds.make_device_decision_fn(EnvConfig(P), "uniform", None, "uniform", 8, 8, 2.0, device="cpu")
    action, logp = single(None, board[0], row_len[0], hand[0], 8, 8, avail[0], obs[0], torch.Generator())
    assert int(action) in hand[0].tolist() and float(logp) == 0.0


# ------------------------------------------------------------------ matches


def test_device_match_searcher_beats_random():
    """The JAX package's strength check (``tests/test_device_match.py``): the
    MCS seat ends ahead of a random seat in more than 60 % of 24 games."""
    cfg = EnvConfig(num_players=2)
    fn = make_device_match_fn(cfg, ("uniform", "random"), None, num_games=24, mc_max=24, device="cpu")
    scores = fn((None, None), torch.Generator().manual_seed(0))
    assert scores.shape == (24, 2) and (scores <= 0).all()
    assert float((scores[:, 0] >= scores[:, 1]).float().mean()) > 0.6


@pytest.mark.parametrize("roster", [("puct", "policy", "random"), ("puct_uniform", "uniform", "random")])
def test_device_match_from_jax_decks(roster):
    """From decks of the JAX package's deal (``jax.random.permutation``): one
    generator state gives one result, and the seats' penalties stay within
    the points of the cards that were in play."""
    cfg = EnvConfig(num_players=3)
    G = 4
    decks = np.stack([np.asarray(jax.random.permutation(k, C)) for k in jax.random.split(jax.random.key(6), G)])
    state = init_from_deck(cfg, torch.from_numpy(decks))
    spec = MLPSpec(cfg.state_length + 1, hidden_sizes=HIDDEN)
    params = mlp_init(torch.Generator().manual_seed(4), spec, device="cpu")
    fn = make_device_match_fn(cfg, roster, spec, num_games=G, mc_max=12, batch=4, device="cpu")
    seat_params = tuple(params if k not in ("random", "uniform") else None for k in roster)
    scores = fn(seat_params, torch.Generator().manual_seed(1), state=state)
    assert torch.equal(scores, fn(seat_params, torch.Generator().manual_seed(1), state=state))
    assert scores.shape == (G, 3) and torch.isfinite(scores).all() and (scores <= 0).all()
    in_play = decks[:, : 3 * H].tolist()
    for g in range(G):
        cards = in_play[g] + [int(decks[g, C - 1 - r]) for r in range(4)]
        total = sum(card_points(c) for c in cards)
        assert -int(scores[g].sum()) <= total
    with pytest.raises(ValueError, match="one kind per seat"):
        make_device_match_fn(cfg, ("uniform", "random"), None, num_games=G, device="cpu")


def test_playout_turns_per_seat():
    cfg = EnvConfig(2)
    # mc_max 200, K 8: 25 rounds while n! * 10 >= 200 (n >= 4), then 60, 20, 10 playouts.
    assert playout_turns_per_seat(cfg, 200) == 25 * sum(range(4, 11)) + 8 * 3 + 3 * 2 + 2 * 1
    assert playout_turns_per_seat(cfg, 100) == 13 * sum(range(4, 11)) + 8 * 3 + 3 * 2 + 2 * 1


def test_search_check_pieces_on_the_cpu():
    """The card-against-CPU check's position and net: K2's openings (the plain
    twin here) with seat 0's card memory, and a net whose logit for card c is
    1.5 + norm(c), exact on any device and different for every card."""
    from rl6nimmt_torch.agents.reinforce import action_in_input_logits
    from rl6nimmt_torch.runtime.search_check import exact_prior, search_position

    cfg = EnvConfig(4)
    board, row_len, hand, avail, obs = search_position(cfg, 3, 5, device="cpu")
    assert hand.shape == (5, H) and (hand >= 0).all() and (row_len == 1).all()
    assert (avail.sum(dim=1) == C - 4 - H).all() and not avail.gather(1, hand.long()).any()
    spec = MLPSpec(cfg.state_length + 1)
    logits = action_in_input_logits(spec, exact_prior(spec, device="cpu"), obs, hand)
    assert torch.equal(logits, 1.5 + (-1.0 + 2.0 * hand.float() / 103))


def test_device_match_bench_runs_the_host_driver_beside(capsys):
    """The bench's host-driver comparison: a GameSession of the host agents
    with device-root decisions, timed beside the device matches."""
    import json

    from rl6nimmt_torch.experiments import device_match_bench

    device_match_bench.main(["--games", "2", "--per-call", "2", "--mc-max", "4", "--host-games", "1",
                             "--roster", "puct_uniform", "random", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["games"] == 2 and out["s_per_match_host_driver"] > 0 and out["speedup_vs_host_driver"] > 0
