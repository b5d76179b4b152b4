"""K6's plain twins (the act-rollout ablation) and K7's (the op probes) against
the JAX engine and ``jnp`` on the same inputs.

The JAX side is the JAX package's engine (``init_from_deck``, ``step``,
``observe``) and ``jnp`` math, fed the port's numpy decks, Philox words and
weights; the JAX ablation module itself needs TPU PRNG ops and is never
imported.  Tolerances are PARITY_TORCH.md section 7's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl6nimmt_tpu.engine import EnvConfig as JaxConfig
from rl6nimmt_tpu.engine import env as jenv
from rl6nimmt_torch.engine import EnvConfig
from rl6nimmt_torch.experiments import act_rollout_ablate as ablate
from rl6nimmt_torch.experiments import probe_ops as probe_exp
from rl6nimmt_torch.ops import probe_ops
from rl6nimmt_torch.ops.act_ablate_kernel import (
    VARIANTS,
    ablate_twin_agreement,
    act_ablate_plain,
    full_head_picks,
    make_act_ablate_kernel,
)
from rl6nimmt_torch.ops.act_rollout_kernel import act_rollout_plain
from rl6nimmt_torch.ops.game_kernel import deal_decks_plain, play_random_games_plain, random_pick_words

G, CHAIN, SEED = 128, 2, 41
RTOL, ATOL = 1e-5, 1e-6
MASK32 = 0xFFFFFFFF
# Decisions whose top-2 gap lies within the tolerance, per (variant, seed); every
# other (variant, seed) here has none.  The one at mm/42 (turn 3, game 85, seat 3)
# has a gap of 0.0547 against a tolerance of 0.0598 on heads up to 6026 in
# magnitude: the two summation orders still pick the same column.
NEAR_TIES = {("mm", 42): 1}


# (players, EnvConfig keywords): the ablation's configuration, then shapes that run
# the runtime-sized instances of K6 env and obs (and, without summaries, the flagship
# instance at another observation length).
SHAPES = {"default": (4, {}), "six_seats": (6, {}), "no_summaries": (4, dict(include_summaries=False)),
          "deck_127": (12, dict(num_cards=127))}


def _config(shape: str = "default") -> EnvConfig:
    players, kw = SHAPES[shape]
    return EnvConfig(players, **kw)


@functools.lru_cache(maxsize=None)
def _jax_engine(shape: str = "default"):
    players, kw = SHAPES[shape]
    jcfg = JaxConfig(players, **kw)
    return (jax.jit(jax.vmap(functools.partial(jenv.init_from_deck, jcfg))),
            jax.jit(jax.vmap(functools.partial(jenv.step, jcfg))),
            jax.jit(jax.vmap(functools.partial(jenv.observe, jcfg))))


@functools.lru_cache(maxsize=None)
def _weights(shape: str = "default"):
    return ablate.weights(_config(shape), "cpu")


def _tol(adv: np.ndarray) -> np.ndarray:
    """Per-entry tolerance of an f32 head: rtol plus atol times the largest magnitude."""
    return RTOL * np.abs(adv) + ATOL * max(1.0, float(np.abs(adv).max()))


def _top2_gap(x: np.ndarray) -> np.ndarray:
    top = np.sort(x, axis=-1)
    return top[..., -1] - top[..., -2]


@functools.lru_cache(maxsize=None)
def _jax_games(variant: str, seed: int, shape: str = "default"):
    """``variant`` played on the JAX engine from the port's decks and words, in
    the configuration ``SHAPES[shape]``: ``(obs int8 [T+1,G,P,S], actions
    [T,G,P], rewards [T,G,P], advs, near_ties)``.  ``advs`` are the per-turn
    ``jnp`` heads (``mm``/``full``); ``near_ties`` counts decisions whose top-2
    gap is within the tolerance."""
    cfg = _config(shape)
    init_j, step_j, obs_j = _jax_engine(shape)
    decks = deal_decks_plain(cfg, seed, G, "cpu").numpy()
    words = random_pick_words(cfg, seed, G, "cpu").numpy()
    w1, b1, wa, ba = (jnp.asarray(x.numpy()) for x in _weights(shape))
    state = init_j(jnp.asarray(decks))
    obs_all, actions, rewards, advs = [], [], [], []
    near_ties = 0
    for t in range(cfg.max_turns):
        o, masks = obs_j(state)
        obs_all.append(np.asarray(o).astype(np.int8))
        hs = np.asarray(state.hands_sorted)
        count = (hs >= 0).sum(-1)
        if variant in ("env", "obs"):
            slot = (words[t] * count) >> 32
        else:
            adv = np.asarray(jnp.maximum(o @ w1[t] + b1[t], 0.0) @ wa[t] + ba[t])
            advs.append(adv)
            if variant == "mm":
                near_ties += int((_top2_gap(adv) <= _tol(adv).max(-1)).sum())
                slot = ((words[t] + adv.argmax(-1)) & MASK32) % count
            else:
                legal = np.where(np.asarray(masks), adv, -np.inf)
                near_ties += int(((_top2_gap(legal) <= _tol(adv).max(-1)) & (count > 1)).sum())
                slot = None
                a = np.asarray(jnp.argmax(jnp.where(masks, jnp.asarray(adv), -1e9), axis=-1))
        if slot is not None:
            a = np.take_along_axis(hs, slot[..., None], -1)[..., 0]
        state, r = step_j(state, jnp.asarray(a, jnp.int32))
        actions.append(a.astype(np.int32))
        rewards.append(np.asarray(r))
    obs_all.append(np.asarray(obs_j(state)[0]).astype(np.int8))
    return np.stack(obs_all), np.stack(actions), np.stack(rewards), advs, near_ties


# ------------------------------------------------------------ K6, per variant


def test_env_twin_matches_jax_engine():
    cfg = ablate.config()
    obs, actions, rewards = act_ablate_plain(cfg, "env", SEED, G, *_weights())
    _, j_actions, j_rewards, _, _ = _jax_games("env", SEED)
    assert obs is None
    np.testing.assert_array_equal(actions.numpy(), j_actions)
    np.testing.assert_array_equal(rewards.numpy(), j_rewards)
    # env's games are K3's: the same per-game reward sums.
    np.testing.assert_array_equal(rewards.sum(0).numpy(), play_random_games_plain(cfg, SEED, G, "cpu")[0].numpy())


def test_obs_twin_matches_jax_engine():
    obs, actions, rewards = act_ablate_plain(ablate.config(), "obs", SEED, G, *_weights())
    j_obs, j_actions, j_rewards, _, _ = _jax_games("obs", SEED)
    assert obs.dtype == torch.int8 and obs.shape == (11, G, 4, 47)
    np.testing.assert_array_equal(obs.numpy(), j_obs)
    np.testing.assert_array_equal(actions.numpy(), j_actions)
    np.testing.assert_array_equal(rewards.numpy(), j_rewards)


@pytest.mark.parametrize("shape", ["six_seats", "no_summaries", "deck_127"])
@pytest.mark.parametrize("variant", ["env", "obs"])
def test_random_twins_match_jax_engine_at_other_shapes(variant, shape):
    """env and obs, whose kernels play K3's games, at shapes of their
    runtime-sized instance (six seats; twelve on the 127-card deck) and without
    summaries (the flagship instance at S=35)."""
    cfg = _config(shape)
    obs, actions, rewards = act_ablate_plain(cfg, variant, SEED, G, *_weights(shape))
    j_obs, j_actions, j_rewards, _, _ = _jax_games(variant, SEED, shape)
    if variant == "env":
        assert obs is None
    else:
        assert obs.dtype == torch.int8 and obs.shape == (cfg.max_turns + 1, G, cfg.num_players, cfg.state_length)
        np.testing.assert_array_equal(obs.numpy(), j_obs)
    np.testing.assert_array_equal(actions.numpy(), j_actions)
    np.testing.assert_array_equal(rewards.numpy(), j_rewards)
    np.testing.assert_array_equal(rewards.sum(0).numpy(), play_random_games_plain(cfg, SEED, G, "cpu")[0].numpy())


def test_mm_twin_matches_jax_head_and_games():
    cfg = ablate.config()
    w = _weights()
    j_obs, j_actions, j_rewards, j_advs, near_ties = _jax_games("mm", SEED)
    assert near_ties == 0            # no decision within the tolerance at these weights and seed
    words = random_pick_words(cfg, SEED, G, "cpu")
    for t, j_adv in enumerate(j_advs):
        # The port's head on JAX's observations of the same turn.
        hs = torch.from_numpy(j_obs[t][..., :cfg.hand_size].astype(np.int32))
        cards, adv = full_head_picks(hs, words[t], torch.from_numpy(j_obs[t]).float(),
                                     *(x[t] for x in w))
        np.testing.assert_allclose(adv.numpy(), j_adv, rtol=RTOL, atol=ATOL * float(np.abs(j_adv).max()))
        decided = _top2_gap(j_adv) > _tol(j_adv).max(-1)
        np.testing.assert_array_equal(cards.numpy()[decided], j_actions[t][decided])
    obs, actions, rewards = act_ablate_plain(cfg, "mm", SEED, G, *w)
    np.testing.assert_array_equal(obs.numpy(), j_obs)
    np.testing.assert_array_equal(actions.numpy(), j_actions)
    np.testing.assert_array_equal(rewards.numpy(), j_rewards)


def test_full_variant_is_k4():
    cfg = ablate.config()
    w = _weights()
    out = make_act_ablate_kernel(cfg, G, ablate.HID, "full")(SEED, *w)
    for x, y in zip(out, act_rollout_plain(cfg, SEED, G, *w)):
        assert torch.equal(x, y)
    j_obs, j_actions, j_rewards, _, near_ties = _jax_games("full", SEED)
    assert near_ties == 0
    np.testing.assert_array_equal(out[0].numpy(), j_obs)
    np.testing.assert_array_equal(out[1].numpy(), j_actions)
    np.testing.assert_array_equal(out[2].numpy(), j_rewards)


@pytest.mark.parametrize("variant", ["env", "obs", "mm"])
def test_kernel_entry_takes_the_twin_on_cpu(variant):
    cfg = ablate.config()
    w = _weights()
    out = make_act_ablate_kernel(cfg, G, ablate.HID, variant)(SEED, *w)
    for x, y in zip(out, act_ablate_plain(cfg, variant, SEED, G, *w)):
        assert (x is None and y is None) or torch.equal(x, y)
    assert ablate_twin_agreement(cfg, variant, G, ablate.HID, SEED, w) == (1.0, G, 0.0)


# ---------------------------------------------------------- the slice as a whole


@pytest.mark.parametrize("variant", VARIANTS)
def test_ablation_checksum_matches_jax(variant):
    """``build`` on the CPU: generation ``i`` plays seed ``seed + i``, and the
    checksum is sum(rewards) + sum(actions) + sum(obs[0]) (no obs for env)."""
    want = 0
    for i in range(CHAIN):
        obs, actions, rewards, _, near_ties = _jax_games(variant, SEED + i)
        assert near_ties == NEAR_TIES.get((variant, SEED + i), 0)
        want += int(rewards.sum()) + int(actions.sum()) + (0 if variant == "env" else int(obs[0].astype(np.int64).sum()))
    got = ablate.build(variant, device="cpu", games=G, chain=CHAIN)(SEED)
    assert got.dtype == torch.int64 and int(got) == want


def test_weights_are_the_jax_scripts_draws():
    rng = np.random.default_rng(0)
    cfg = ablate.config()
    T, S, A = cfg.max_turns, cfg.state_length, cfg.num_actions
    for x, shape in zip(_weights(), [(T, S, 64), (T, 64), (T, 64, A), (T, A)]):
        np.testing.assert_array_equal(x.numpy(), rng.normal(size=shape).astype(np.float32))


# ------------------------------------------------------------------------ K7


def _jnp_reference(key, inp):
    n = {k: jnp.asarray(v.numpy()) for k, v in inp.items()}
    if key == "k1":
        return n["C"].T @ n["W1"]
    if key == "k2":
        return n["hands"].T
    if key == "k3":
        return jnp.argmax(n["H"], axis=1)[:, None].astype(jnp.int32)
    if key == "k4":
        return n["flat"].reshape(8, 128)
    if key == "k5":
        return jnp.transpose(n["S"], (1, 2, 0)).reshape(1024, 47)
    if key == "k6":
        return jnp.einsum("fsl,fh->slh", n["S2"], n["W1b"])
    adv = jnp.einsum("slh,ha->sla", n["H3"], n["Wa"])
    iota = jax.lax.broadcasted_iota(jnp.int32, (8, 128, 104), 2)
    return jnp.argmax(jnp.where(iota == n["hand"][:, :, None], adv, -1e9), axis=2).astype(jnp.int32)


@pytest.mark.parametrize("key", [f"k{i}" for i in range(1, 8)])
def test_probe_twin_matches_jnp(key):
    inp = probe_exp.probe_inputs("cpu")
    (_, _, kernel, twin, args, exact), = [p for p in probe_exp.probes(inp) if p[0] == key]
    got = twin(*args)
    want = np.asarray(_jnp_reference(key, inp))
    if exact:
        assert got.dtype == torch.int32 or got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()))
    assert torch.equal(kernel(*args), got)         # the wrapper takes the twin on the CPU


@pytest.mark.parametrize("A", [1, 103, 200])
def test_k7_twin_matches_jnp_at_its_edges(A):
    """The rule the k7 kernel implements, pinned on the CPU: the twin equals
    ``jnp.argmax(jnp.where(iota == hand, h @ wa, -1e9))`` on rows whose hand is
    out of range or whose masked value is -1e9, just below or above it, or NaN."""
    h, wa, hand = probe_exp.k7_edge_inputs(A, "cpu")
    got = probe_ops.dot_mask_argmax_plain(h, wa, hand)
    adv = jnp.einsum("slh,ha->sla", jnp.asarray(h.numpy()), jnp.asarray(wa.numpy()))
    iota = jax.lax.broadcasted_iota(jnp.int32, adv.shape, 2)
    want = jnp.argmax(jnp.where(iota == jnp.asarray(hand.numpy())[..., None], adv, -1e9), axis=2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # hands -1, A and A + 7 give 0; then hand 0 at -2e9 (column 1 wins), and at
    # A > 4 the hands 1-4 at -1e9 (a tie: column 0), below it, above it and NaN.
    edges = [0, 0, 0, 1 if A > 1 else 0] + ([0, 0, 3, 4] if A > 4 else [])
    assert got[0, :len(edges)].tolist() == edges


def test_probe_entry_point_on_cpu(capsys):
    results = probe_exp.run("cpu")
    assert [r["probe"] for r in results] == [f"k{i}" for i in range(1, 8)]
    assert all(r["ok"] for r in results)
    assert capsys.readouterr().out.count(": OK") == 7


# ---------------------------------------------------------------- validation


def test_ablation_validation():
    cfg = ablate.config()
    w1, b1, wa, ba = _weights()
    for bad in (lambda: make_act_ablate_kernel(cfg, G, 64, "greedy"),
                lambda: act_ablate_plain(cfg, "nope", 0, G, w1, b1, wa, ba),
                lambda: ablate.build("bogus", device="cpu", games=G, chain=1)):
        with pytest.raises(ValueError, match="variant"):
            bad()
    for variant in ("env", "mm", "full"):
        with pytest.raises(ValueError, match="hidden"):
            make_act_ablate_kernel(cfg, G, 300, variant)
    play = make_act_ablate_kernel(cfg, G, 64, "obs")
    with pytest.raises(ValueError, match="shape"):
        play(0, w1[:, :40], b1, wa, ba)
    with pytest.raises(TypeError, match="float32"):
        play(0, w1, b1.double(), wa, ba)
    with pytest.raises(ValueError, match="device"):
        play(0, *(x.to("meta") for x in (w1, b1, wa, ba)))
    with pytest.raises(ValueError, match="seed"):
        play(-1, w1, b1, wa, ba)


def test_probe_validation():
    inp = probe_exp.probe_inputs("cpu")
    with pytest.raises(ValueError, match="w must be"):
        probe_ops.dot_lhs_t(inp["C"], inp["Wa"])
    with pytest.raises(ValueError, match="dims"):
        probe_ops.dot_3d(inp["C"], inp["W1"])
    with pytest.raises(TypeError, match="int32"):
        probe_ops.transpose_2d(inp["C"])
    with pytest.raises(ValueError, match="rows"):
        probe_ops.reshape_rows(inp["flat"], 7)
    with pytest.raises(ValueError, match="contiguous"):
        probe_ops.argmax_rows(inp["H"].t())
    with pytest.raises(ValueError, match="hand"):
        probe_ops.dot_mask_argmax(inp["H3"], inp["Wa"], inp["hand"][:4])
    with pytest.raises(ValueError, match="device"):
        probe_ops.transpose_3d(inp["S"].to("meta"))
