"""K3's and K4's plain twins vs JAX compositions on the same decks and picks,
and K5's twin vs the n-step harvest of K4's twin."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl6nimmt_tpu.agents.dqn import DQNConfig as JaxDQNConfig
from rl6nimmt_tpu.agents.dqn import q_network_spec as jax_spec_of
from rl6nimmt_tpu.agents.dqn import q_values as jax_q_values
from rl6nimmt_tpu.engine import EnvConfig as JaxConfig
from rl6nimmt_tpu.engine import env as jenv
from rl6nimmt_tpu.nets import draw_mlp_noise, mlp_init, noisy_effective_params
from rl6nimmt_torch.agents.dqn import DQNConfig, q_network_spec
from rl6nimmt_torch.engine import EnvConfig
from rl6nimmt_torch.nets import noise_from_jax, params_from_jax
from rl6nimmt_torch.ops.act_rollout_check import (
    greedy_replay_agreement,
    insert_planes_agreement,
    turn_effective_weights,
)
from rl6nimmt_torch.ops.act_rollout_kernel import act_rollout_plain, make_act_rollout_kernel
from rl6nimmt_torch.ops.game_kernel import (
    deal_decks_plain,
    play_random_games,
    play_random_games_plain,
    random_pick_words,
)
from rl6nimmt_torch.runtime.vector import make_random_rollout, make_random_rollout_generations

G = 16
FLAGSHIP = dict(double=True, dueling=True, noisy=True, per=True, n_steps=10,
                hidden_sizes=(64,), minibatch=64)


def _jax_engine(jcfg):
    return (jax.jit(jax.vmap(functools.partial(jenv.init_from_deck, jcfg))),
            jax.jit(jax.vmap(functools.partial(jenv.step, jcfg))),
            jax.jit(jax.vmap(functools.partial(jenv.observe, jcfg))))


@pytest.mark.parametrize("num_players,include_summaries", [(2, True), (4, True), (6, True), (4, False)])
def test_random_games_plain_matches_jax_composition(num_players, include_summaries):
    cfg = EnvConfig(num_players, include_summaries=include_summaries)
    jcfg = JaxConfig(num_players, include_summaries=include_summaries)
    init_j, step_j, obs_j = _jax_engine(jcfg)
    seed = 77 + num_players
    decks = deal_decks_plain(cfg, seed, G, "cpu").numpy()
    words = random_pick_words(cfg, seed, G, "cpu").numpy()
    state = init_j(jnp.asarray(decks))
    total = np.zeros((G, num_players), np.int64)
    checksum = np.zeros(G, np.int64)
    for t in range(cfg.max_turns):
        obs, _ = obs_j(state)
        checksum += np.asarray(obs).sum(axis=(1, 2)).astype(np.int64)
        hs = np.asarray(state.hands_sorted)
        r = (words[t] * (hs >= 0).sum(-1)) >> 32
        actions = np.take_along_axis(hs, r[..., None], -1)[..., 0]
        state, rew = step_j(state, jnp.asarray(actions, jnp.int32))
        total += np.asarray(rew)
    rewards, cs = play_random_games_plain(cfg, seed, G, "cpu")
    np.testing.assert_array_equal(rewards.numpy(), total)
    np.testing.assert_array_equal(cs.numpy(), checksum.astype(np.float32))
    np.testing.assert_array_equal(total.sum(1), -np.asarray(state.scores).sum(1))


def test_random_rollout_fused_and_engine_paths_agree():
    """K3 (fused) and the engine path (K2 + K1) draw the same Philox words,
    so one seed gives the same totals and checksums."""
    cfg = EnvConfig(4)
    fused = make_random_rollout_generations(cfg, G, 3, fused=True, device="cpu")(5)
    engine = make_random_rollout_generations(cfg, G, 3, fused=False, device="cpu")(5)
    assert torch.equal(fused[0], engine[0])
    assert float(fused[1]) == float(engine[1])
    state, total, checksum = make_random_rollout(cfg, G, device="cpu")(5)
    r, cs = play_random_games(cfg, 5, G, device="cpu")
    assert torch.equal(total, r) and float(checksum) == float(cs.double().sum())
    assert torch.equal(-state.scores, total)


def _flagship(num_players=4, key=0):
    jcfg = JaxConfig(num_players)
    jdqn = JaxDQNConfig(**FLAGSHIP)
    jspec = jax_spec_of(jdqn, jcfg.state_length, jcfg.num_actions)
    jparams = mlp_init(jax.random.key(key), jspec)
    keys = jax.random.split(jax.random.key(key + 1), 10)
    jnoise = jax.vmap(lambda k: draw_mlp_noise(jspec, k))(keys)
    return jcfg, jdqn, jspec, jparams, jnoise


@pytest.mark.parametrize("num_players", [2, 4])
def test_act_rollout_plain_matches_jax_greedy_replay(num_players):
    jcfg, jdqn, jspec, jparams, jnoise = _flagship(num_players)
    cfg, dqn = EnvConfig(num_players), DQNConfig(**FLAGSHIP)
    spec = q_network_spec(dqn, cfg.state_length, cfg.num_actions)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    noise = noise_from_jax(jax.tree.map(np.asarray, jnoise), "cpu")
    eff = turn_effective_weights(spec, params, noise)
    seed = 31
    obs, actions, rewards = act_rollout_plain(cfg, seed, G, eff["trunk"][0]["w"], eff["trunk"][0]["b"],
                                              eff["heads"][1]["w"], eff["heads"][1]["b"])
    # JAX: the XLA greedy act (full dueling Q, legal mask) on the same decks.
    init_j, step_j, obs_j = _jax_engine(jcfg)
    jeff = jax.vmap(lambda nz: noisy_effective_params(jspec, jparams, nz))(jnoise)
    eff_spec = dataclasses.replace(jspec, noisy=False)
    state = init_j(jnp.asarray(deal_decks_plain(cfg, seed, G, "cpu").numpy()))
    j_actions, j_obs = [], []
    for t in range(cfg.max_turns):
        o, masks = obs_j(state)
        j_obs.append(np.asarray(o))
        q = jax_q_values(jdqn, eff_spec, jax.tree.map(lambda x: x[t], jeff), o)
        a = jnp.argmax(jnp.where(masks, q, -1e9), axis=-1).astype(jnp.int32)
        j_actions.append(np.asarray(a))
        state, _ = step_j(state, a)
    j_obs.append(np.asarray(obs_j(state)[0]))
    j_actions = np.stack(j_actions)
    agree = (j_actions == actions.numpy()).mean()
    assert agree >= 0.999
    same = (j_actions == actions.numpy()).all(axis=(0, 2))          # games that agree
    np.testing.assert_array_equal(obs.numpy()[:, same], np.stack(j_obs)[:, same].astype(np.int8))
    np.testing.assert_array_equal(rewards.numpy().sum(0)[same], -np.asarray(state.scores)[same])


def test_act_rollout_entry_and_replay_check_on_cpu():
    """The K4 entry point takes its plain twin on CPU weights, and the
    port's greedy-replay protocol agrees on it."""
    jcfg, jdqn, jspec, jparams, jnoise = _flagship(4, key=3)
    cfg, dqn = EnvConfig(4), DQNConfig(**FLAGSHIP)
    spec = q_network_spec(dqn, cfg.state_length, cfg.num_actions)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    noise = noise_from_jax(jax.tree.map(np.asarray, jnoise), "cpu")
    eff = turn_effective_weights(spec, params, noise)
    play = make_act_rollout_kernel(cfg, G, hidden=64)
    args = (eff["trunk"][0]["w"], eff["trunk"][0]["b"], eff["heads"][1]["w"], eff["heads"][1]["b"])
    out = play(9, *args)
    for x, y in zip(out, act_rollout_plain(cfg, 9, G, *args)):
        assert torch.equal(x, y)
    assert out[0].shape == (11, G, 4, 47) and out[0].dtype == torch.int8
    # Every chosen action was in the acting seat's hand at that turn.
    hands = out[0][:10, :, :, :10].long()
    assert bool((hands == out[1][..., None].long()).any(-1).all())
    action_agree, score_agree = greedy_replay_agreement(cfg, dqn, spec, params, G, 9, noise)
    assert action_agree >= 0.999 and score_agree >= 0.999


# ------------------------------------------------------------------ K5 (twin)

KD_G, KD_CAP, KD_PTR = 256, 3 * 5120, 2 * 5120   # two tiles; tile 1 wraps to block 0


def _k5_args(key=5):
    jcfg, jdqn, jspec, jparams, jnoise = _flagship(4, key=key)
    cfg, dqn = EnvConfig(4), DQNConfig(**FLAGSHIP)
    spec = q_network_spec(dqn, cfg.state_length, cfg.num_actions)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    noise = noise_from_jax(jax.tree.map(np.asarray, jnoise), "cpu")
    eff = turn_effective_weights(spec, params, noise)
    args = (eff["trunk"][0]["w"], eff["trunk"][0]["b"], eff["heads"][1]["w"], eff["heads"][1]["b"])
    return cfg, dqn, spec, params, noise, args


@pytest.mark.parametrize("reward_lag,n_steps", [(True, 10), (False, 12)])
def test_act_insert_plain_matches_harvest(reward_lag, n_steps):
    """K5's twin at two tiles with a wrapping ptr equals, column for column,
    the n-step harvest (``to_transitions``) of K4's twin's trajectory; pad
    rows are zero and the columns it does not own keep their contents."""
    from rl6nimmt_torch.ops.act_rollout_check import column_order
    from rl6nimmt_torch.ops.act_rollout_kernel import S_PAD, SCAL_ROWS, TILE, make_act_insert_kernel
    from rl6nimmt_torch.runtime.vector import to_transitions

    cfg, _, _, _, _, args = _k5_args()
    T, P, S, seed = cfg.max_turns, cfg.num_players, cfg.state_length, 17
    st = torch.full((S_PAD, KD_CAP), 5, dtype=torch.int8)
    nx = torch.full((S_PAD, KD_CAP), 6, dtype=torch.int8)
    sc = torch.full((SCAL_ROWS, KD_CAP), 7.0)
    insert = make_act_insert_kernel(cfg, KD_G, 64, KD_CAP, 0.99, n_steps, reward_lag)
    out = insert(seed, KD_PTR, *args, st, nx, sc)
    assert out[0] is st and out[1] is nx and out[2] is sc                 # in place
    obs, actions, rewards = act_rollout_plain(cfg, seed, KD_G, *args)
    np.testing.assert_array_equal(out[3].numpy(), rewards.permute(0, 2, 1).reshape(T * P, KD_G).numpy())
    rm = to_transitions(cfg, 0.99, n_steps, reward_lag, obs[:T], actions, rewards.float(), obs[1:])
    want = {k: column_order(v, T, KD_G, P) for k, v in rm.items()}     # [..., T, P, G]
    written = np.zeros(KD_CAP, bool)
    for tile in range(KD_G // TILE):                   # the column map, written out
        base = (KD_PTR // TILE + tile * T * P) % (KD_CAP // TILE)
        gs = slice(tile * TILE, (tile + 1) * TILE)
        for t in range(T):
            for p in range(P):
                cols = slice((base + t * P + p) * TILE, (base + t * P + p + 1) * TILE)
                written[cols] = True
                np.testing.assert_array_equal(st[:S, cols].numpy(), want["state"][:, t, p, gs].numpy())
                np.testing.assert_array_equal(nx[:S, cols].numpy(), want["next_state"][:, t, p, gs].numpy())
                np.testing.assert_array_equal(sc[1, cols].numpy(), want["action"][t, p, gs].float().numpy())
                np.testing.assert_array_equal(sc[2, cols].numpy(), want["done"][t, p, gs].numpy())
                np.testing.assert_allclose(sc[0, cols].numpy(), want["reward"][t, p, gs].numpy(),
                                           rtol=1e-6, atol=1e-5)
    assert written.sum() == T * P * KD_G and not written[5120:10240].any()
    assert bool((st[S:, written] == 0).all() and (nx[S:, written] == 0).all() and (sc[3:, written] == 0).all())
    assert bool((st[:, ~written] == 5).all() and (nx[:, ~written] == 6).all() and (sc[:, ~written] == 7).all())


def test_insert_planes_agreement_on_cpu():
    """The K5-vs-K4 protocol runs through the twins on CPU tensors."""
    cfg, dqn, spec, params, noise, _ = _k5_args(key=7)
    err = insert_planes_agreement(cfg, dqn, spec, params, KD_G, KD_CAP, 23, KD_PTR, noise)
    assert 0.0 <= err <= 1e-3


@pytest.mark.parametrize("case", ["capacity", "capacity_below_one_insert", "ptr", "num_games",
                                  "n_steps", "planes", "misaligned"])
def test_act_insert_kernel_validation(case):
    from rl6nimmt_torch.ops.act_rollout_kernel import S_PAD, SCAL_ROWS, make_act_insert_kernel

    cfg, _, _, _, _, args = _k5_args()
    bad = {"capacity": (dict(capacity=200_000), "capacity"),
           "num_games": (dict(num_games=100), "num_games"),
           "n_steps": (dict(n_steps=3), "n_steps"),
           # 512 games own 4 tiles of 5120 columns: two would share a block of a 15360 ring
           "capacity_below_one_insert": (dict(num_games=512), "below one insert")}
    if case in bad:
        kw = dict(dict(num_games=KD_G, capacity=KD_CAP, n_steps=10), **bad[case][0])
        with pytest.raises(ValueError, match=bad[case][1]):
            make_act_insert_kernel(cfg, kw["num_games"], 64, kw["capacity"], 0.99, kw["n_steps"])
        return
    insert = make_act_insert_kernel(cfg, KD_G, 64, KD_CAP, 0.99, 10)
    planes = [torch.zeros((S_PAD, KD_CAP), dtype=torch.int8), torch.zeros((S_PAD, KD_CAP), dtype=torch.int8),
              torch.zeros((SCAL_ROWS, KD_CAP))]
    ptr = 128 if case == "ptr" else 0                  # not a multiple of T*P*128
    if case == "planes":
        planes[2] = planes[2].double()
    if case == "misaligned":   # contiguous, but one byte past a 16-byte boundary
        planes[0] = torch.zeros(S_PAD * KD_CAP + 1, dtype=torch.int8)[1:].view(S_PAD, KD_CAP)
    match = {"ptr": "ptr", "misaligned": "state must start on a 16-byte boundary"}.get(case, "scal")
    with pytest.raises((ValueError, TypeError), match=match):
        insert(1, ptr, *args, *planes)
