"""One Bellman update and one whole self-play cycle: port vs JAX.

The JAX cycle draws from threefry keys, which the port cannot replay, so the
test re-derives the JAX cycle's key schedule with ``jax.random`` (decks,
per-turn noise, learn noise, PER uniforms; runtime/vector.py ``cycle``) and
injects the same numbers into the port as a ``CycleRandomness``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl6nimmt_tpu.agents import dqn as jdqn_mod
from rl6nimmt_tpu.buffers import per_init as jax_per_init
from rl6nimmt_tpu.engine import EnvConfig as JaxConfig
from rl6nimmt_tpu.nets import draw_mlp_noise as jax_draw_noise
from rl6nimmt_tpu.nets import mlp_init as jax_mlp_init
from rl6nimmt_tpu.runtime import vector as jvec
from rl6nimmt_torch.agents import dqn as tdqn
from rl6nimmt_torch.buffers import per as tper
from rl6nimmt_torch.buffers import per_init
from rl6nimmt_torch.engine import EnvConfig
from rl6nimmt_torch.nets import noise_from_jax, params_from_jax, params_to_numpy
from rl6nimmt_torch.runtime import vector as tvec

RTOL, ATOL = 1e-5, 1e-6
FLAGSHIP = dict(double=True, dueling=True, noisy=True, per=True, n_steps=10,
                hidden_sizes=(64,), minibatch=64)
EPS_GREEDY = dict(double=True, dueling=True, noisy=False, per=True, n_steps=3,
                  hidden_sizes=(32,), minibatch=64)
G, CAP, ITERS = 8, 2048, 2


def assert_f32_close(actual, desired, err_msg=""):
    """rtol 1e-5, atol 1e-6 scaled by the tensor's largest magnitude: XLA and
    torch reassociate f32 sums whose terms (card ids up to 103 times weights)
    are far larger than a result that cancels to near zero."""
    desired = np.asarray(desired)
    scale = max(1.0, float(np.abs(desired).max()))
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=RTOL, atol=ATOL * scale,
                               err_msg=err_msg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_params(tp, jp, what):
    for a, b in zip(jax.tree.leaves(params_to_numpy(tp)), jax.tree.leaves(_np(jp))):
        assert_f32_close(a, b, err_msg=what)


def _learn_noise_to_torch(noise):
    ev, tg = noise
    return noise_from_jax(_np(ev), "cpu"), tuple(noise_from_jax(_np(n), "cpu") for n in tg)


def test_learn_step_matches_jax():
    jcfg = JaxConfig(4)
    jd = jdqn_mod.DQNConfig(**FLAGSHIP)
    td = tdqn.DQNConfig(**FLAGSHIP)
    jspec = jdqn_mod.q_network_spec(jd, 47, 104)
    tspec = tdqn.q_network_spec(td, 47, 104)
    jparams = jax_mlp_init(jax.random.key(0), jspec)
    jtarget = jax_mlp_init(jax.random.key(1), jspec)
    opt = optax.adam(1e-3)
    jopt = opt.init(jparams)
    rng = np.random.RandomState(0)
    batch = {
        "state": rng.randint(-1, 104, size=(64, 47)).astype(np.float32),
        "action": rng.randint(0, 104, size=64).astype(np.int32),
        "reward": rng.randn(64).astype(np.float32) * 3,
        "next_state": rng.randint(-1, 104, size=(64, 47)).astype(np.float32),
        "done": (rng.rand(64) < 0.3).astype(np.float32),
        "weights": rng.rand(64).astype(np.float32),
    }
    noise = jdqn_mod.learn_noise(jd, jspec, jax.random.key(2))
    jstep = jdqn_mod.make_learn_step(jd, jspec, opt, 0.99)
    tstep = tdqn.make_learn_step(td, tspec, tdqn.Adam(1e-3), 0.99)
    tp, tt = params_from_jax(_np(jparams), "cpu"), params_from_jax(_np(jtarget), "cpu")
    topt = tdqn.Adam(1e-3).init(tp)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    tbatch["action"] = tbatch["action"].long()
    tnoise = _learn_noise_to_torch(noise)
    for it in range(2):        # two updates: exercises Adam's moments and bias correction
        out_j = jstep(jparams, jtarget, jopt, batch, it == 0, None, noise=noise)
        jparams, jtarget, jopt, jloss, jerr, jq = out_j
        tp, tt, topt, tloss, terr, tq = tstep(tp, tt, topt, tbatch, it == 0, noise=tnoise)
        assert_f32_close(tloss.numpy(), jloss, err_msg=f"loss {it}")
        assert_f32_close(terr.numpy(), jerr, err_msg=f"abs_err {it}")
        assert_f32_close(tq.numpy(), jq, err_msg=f"q_target {it}")
        _assert_params(tp, jparams, f"params {it}")
        _assert_params(tt, jtarget, f"target {it}")


def _replay_jax_schedule(jcfg, jd, jspec, key, num_games, learn_iters):
    """The random numbers one JAX ``cycle(key)`` consumes, as a CycleRandomness."""
    T = jcfg.max_turns
    roll_key, learn_key = jax.random.split(key)
    key2, deal_key = jax.random.split(roll_key)
    decks = jax.vmap(lambda k: jax.random.permutation(k, jcfg.num_cards))(
        jax.random.split(deal_key, num_games))
    subs, k = [], key2
    for _ in range(T):
        k, sub = jax.random.split(k)
        subs.append(sub)
    rnd = tvec.CycleRandomness(per_uniforms=None, decks=torch.tensor(np.asarray(decks)))
    if jd.noisy:
        noise_keys = jnp.stack([jax.random.split(s, 3)[0] for s in subs])
        turn_noise = jax.vmap(lambda nk: jax_draw_noise(jspec, nk))(noise_keys)
        rnd.turn_noise = noise_from_jax(_np(turn_noise), "cpu")
    else:
        explore, pick = [], []
        for s in subs:
            _, eps_key, rand_key = jax.random.split(s, 3)
            explore.append(np.asarray(jax.random.uniform(eps_key, (num_games, jcfg.num_players))))
            pick.append(np.asarray(jax.random.uniform(rand_key, (num_games, jcfg.num_players))))
        rnd.explore_u, rnd.pick_u = torch.tensor(np.stack(explore)), torch.tensor(np.stack(pick))
    learn_keys = jax.random.split(learn_key, learn_iters)
    rnd.per_uniforms = torch.tensor(np.stack([
        np.asarray(jax.random.uniform(jax.random.split(k)[0], (jd.minibatch,))) for k in learn_keys]))
    if jd.noisy:
        rnd.learn_noise = [_learn_noise_to_torch(jdqn_mod.learn_noise(jd, jspec, jax.random.split(k)[1]))
                           for k in learn_keys]
    return rnd


@pytest.mark.parametrize("flags,cycles", [(FLAGSHIP, 2), (EPS_GREEDY, 1)],
                         ids=["flagship", "eps_greedy"])
def test_selfplay_cycle_matches_jax(flags, cycles):
    jcfg, cfg = JaxConfig(4), EnvConfig(4)
    jd, td = jdqn_mod.DQNConfig(**flags), tdqn.DQNConfig(**flags)
    jspec = jdqn_mod.q_network_spec(jd, 47, 104)
    opt = optax.adam(1e-3)
    jparams = jax_mlp_init(jax.random.key(10), jspec)
    jtarget = jax.tree.map(jnp.copy, jparams)
    jopt = opt.init(jparams)
    jbuf = jax_per_init(CAP, jvec.dqn_replay_example(jcfg, compact=True))
    jcycle = jvec.make_dqn_selfplay_step(jcfg, jd, opt, G, learn_iters=ITERS)

    tp = params_from_jax(_np(jparams), "cpu")
    tt = params_from_jax(_np(jtarget), "cpu")
    adam = tdqn.Adam(1e-3)
    topt = adam.init(tp)
    tbuf = per_init(CAP, tvec.dqn_replay_example(cfg, compact=True), device="cpu")
    tcycle = tvec.make_dqn_selfplay_step(cfg, td, adam, G, learn_iters=ITERS, device="cpu")

    eps = 0.3
    for c, key in enumerate(jax.random.split(jax.random.key(42), cycles)):   # step0 = c * ITERS
        rnd = _replay_jax_schedule(jcfg, jd, jspec, key, G, ITERS)
        jparams, jtarget, jopt, jbuf, jm = jcycle(jparams, jtarget, jopt, jbuf, key,
                                                  jnp.asarray(eps), c * ITERS)
        tp, tt, topt, tbuf, tm = tcycle(tp, tt, topt, tbuf, rnd, eps, c * ITERS)
        # Transitions and PER storage: bit-exact (n-step rewards allclose).
        for k in ("state", "action", "next_state", "done"):
            np.testing.assert_array_equal(tbuf.storage[k].numpy(), np.asarray(jbuf.storage[k]),
                                          err_msg=f"{k} cycle {c}")
        assert_f32_close(tbuf.storage["reward"].numpy(), jbuf.storage["reward"], f"reward {c}")
        assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size))
        # A priority is (|q_eval - q_target| + 0.01)^0.6 (clipped at 1): the TD
        # error inherits the absolute rounding of two Q values (1e-6 of the Q
        # scale each), and the power's slope is at most 0.6 * 0.01^-0.4 < 3.8.
        live = tbuf.storage["state"][: tbuf.size].float()
        q_scale = max(1.0, float(tdqn.q_values(td, tdqn.q_network_spec(td, 47, 104), tp, live).abs().max()))
        np.testing.assert_allclose(tbuf.priorities.numpy(), np.asarray(jbuf.priorities),
                                   rtol=RTOL, atol=3.8 * 2 * ATOL * q_scale, err_msg=f"priorities {c}")
        np.testing.assert_allclose(float(tbuf.beta), float(jbuf.beta), rtol=1e-6)
        assert float(tm["mean_score"]) == float(jm["mean_score"])
        assert_f32_close(tm["loss"].numpy(), jm["loss"], f"loss {c}")
        _assert_params(tp, jparams, f"params cycle {c}")
        _assert_params(tt, jtarget, f"target cycle {c}")


RING_EPS_GREEDY = dict(double=False, dueling=False, noisy=False, per=False, n_steps=1,
                       hidden_sizes=(32,), minibatch=64)


@pytest.mark.parametrize("flags,kernel_act_rollout", [(FLAGSHIP, False), (FLAGSHIP, True),
                                                      (RING_EPS_GREEDY, False)],
                         ids=["engine", "k4", "ring_eps_greedy"])
def test_cycle_is_deterministic_given_randomness(flags, kernel_act_rollout):
    """Same state and same drawn randomness -> bit-identical params and loss
    (the eager counterpart of bench.py's chained-vs-sequential guard); the
    last case runs the non-PER ring insert and uniform sample."""
    from rl6nimmt_torch.buffers import ring_init
    from rl6nimmt_torch.nets import mlp_init

    cfg, td = EnvConfig(4), tdqn.DQNConfig(**flags)
    spec = tdqn.q_network_spec(td, 47, 104)
    params = mlp_init(torch.Generator().manual_seed(0), spec, device="cpu")
    adam = tdqn.Adam(1e-3)
    example = tvec.dqn_replay_example(cfg)
    cycle = tvec.make_dqn_selfplay_step(cfg, td, adam, G, learn_iters=ITERS,
                                        kernel_act_rollout=kernel_act_rollout, device="cpu")
    rnd = tvec.draw_cycle_randomness(cfg, td, G, ITERS, torch.Generator().manual_seed(1))
    fresh = (lambda: per_init(CAP, example, device="cpu")) if td.per else (lambda: ring_init(CAP, example, device="cpu"))
    outs = [cycle(params, params, adam.init(params), fresh(), rnd, 0.5) for _ in range(2)]
    (p1, _, _, b1, m1), (p2, _, _, b2, m2) = outs
    assert torch.equal(m1["loss"], m2["loss"]) and bool(torch.isfinite(m1["loss"]))
    for a, b in zip(tdqn.tree_leaves(p1), tdqn.tree_leaves(p2)):
        assert torch.equal(a, b)
    for k in b1.storage:
        assert torch.equal(b1.storage[k], b2.storage[k])
    assert (b1.ptr, b1.size) == (G * 4 * 10, G * 4 * 10)
    # Every stored action was in the acting seat's hand (state slots 0..9).
    n = b1.size
    hands = b1.storage["state"][:n, :10].long()
    assert bool((hands == b1.storage["action"][:n, None].long()).any(dim=1).all())


KD_G = 128                       # one 128-game tile: K5's columns run in (t, p, g) order
KD_CAP = 2 * 10 * 4 * KD_G       # two cycles fill it; the second insert lands at ptr 5120


def test_kernel_insert_cycle_matches_k4_cycle(monkeypatch):
    """K5's path (twin on the CPU) equals the row-major cycle on K4 (twin)
    given the same randomness, under the column map (t, p, g) <-> (t, g, p):
    planes bit-exact against the row-major storage (rewards allclose:
    recursion vs windowed sum), the same inserted priorities and first sampled
    indices, then loss, priorities and params allclose.

    The row-major run samples through ``perm`` (kd slot -> row-major slot):
    it draws from its priorities in kd slot order and maps the drawn slots
    back, so both learners see the same transitions in the same order."""
    from rl6nimmt_torch.buffers import PERState
    from rl6nimmt_torch.nets import mlp_init
    from rl6nimmt_torch.ops.act_rollout_check import column_order
    from rl6nimmt_torch.ops.act_rollout_kernel import S_PAD, SCAL_ROWS

    cfg, td = EnvConfig(4), tdqn.DQNConfig(**FLAGSHIP)
    T, P = cfg.max_turns, cfg.num_players
    spec = tdqn.q_network_spec(td, 47, 104)
    params = mlp_init(torch.Generator().manual_seed(3), spec, device="cpu")
    adam = tdqn.Adam(1e-3)
    kd = tvec.make_dqn_selfplay_step(cfg, td, adam, KD_G, learn_iters=ITERS, kernel_insert=True,
                                     device="cpu")
    rm = tvec.make_dqn_selfplay_step(cfg, td, adam, KD_G, learn_iters=ITERS, kernel_act_rollout=True,
                                     device="cpu")
    perm = torch.arange(KD_CAP).reshape(2, T, KD_G, P).permute(0, 1, 3, 2).reshape(-1)
    sampled = []
    per_sample = tvec.per_sample

    def recording_sample(buf, u, n, slot_axis=0):
        if slot_axis == -1:                                   # kd
            out = per_sample(buf, u, n, slot_axis=-1)
            sampled.append((out[1].clone(), buf.priorities.clone()))
            return out
        kd_view = PERState(buf.storage, buf.priorities[perm], buf.ptr, buf.size, buf.beta)
        view, idx, weights, _ = per_sample(kd_view, u, n)
        sampled.append((idx.clone(), kd_view.priorities.clone()))
        rm_idx = perm[idx]
        batch = {k: v[rm_idx] for k, v in buf.storage.items()}
        return PERState(buf.storage, buf.priorities, buf.ptr, buf.size, view.beta), rm_idx, weights, batch

    monkeypatch.setattr(tvec, "per_sample", recording_sample)
    buffers = {"kd": tper.per_init_kd(KD_CAP, S_PAD, SCAL_ROWS, device="cpu"),
               "rm": per_init(KD_CAP, tvec.dqn_replay_example(cfg), device="cpu")}
    states = {name: [params, params, adam.init(params), buf] for name, buf in buffers.items()}
    gen = torch.Generator().manual_seed(4)
    for c in range(2):
        rnd = tvec.draw_cycle_randomness(cfg, td, KD_G, ITERS, gen)
        metrics, first = {}, {}
        for name, cycle in (("kd", kd), ("rm", rm)):
            sampled.clear()
            *states[name], metrics[name] = cycle(*states[name], rnd, 0.0, c * ITERS)
            first[name] = sampled[0]      # (kd-order indices, priorities) of the first update
        assert torch.equal(first["kd"][0], first["rm"][0]), f"first sampled indices, cycle {c}"
        kbuf, rbuf = states["kd"][3], states["rm"][3]
        if c == 0:   # fresh buffer: every inserted priority is exactly 1
            assert torch.equal(first["kd"][1], first["rm"][1])
        planes = kbuf.storage
        want = {k: column_order(v, 2 * T, KD_G, P).reshape(v.shape[1:] + (KD_CAP,))
                for k, v in rbuf.storage.items()}               # row-major slots in kd column order
        assert torch.equal(planes["state"][:47], want["state"])
        assert torch.equal(planes["next_state"][:47], want["next_state"])
        assert bool((planes["state"][47:] == 0).all() and (planes["next_state"][47:] == 0).all())
        assert torch.equal(planes["scalars"][1], want["action"].float())
        assert torch.equal(planes["scalars"][2], want["done"].float())
        assert_f32_close(planes["scalars"][0].numpy(), want["reward"].numpy(), f"reward {c}")
        inserted = (c + 1) * KD_CAP // 2
        assert (kbuf.ptr, kbuf.size) == (rbuf.ptr, rbuf.size) == (inserted % KD_CAP, inserted)
        assert float(metrics["kd"]["mean_score"]) == float(metrics["rm"]["mean_score"])
        assert_f32_close(metrics["kd"]["loss"].numpy(), metrics["rm"]["loss"].numpy(), f"loss {c}")
        live = rbuf.storage["state"][rbuf.priorities > 0].float()
        q_scale = max(1.0, float(tdqn.q_values(td, spec, states["rm"][0], live).abs().max()))
        np.testing.assert_allclose(kbuf.priorities.numpy(), rbuf.priorities[perm].numpy(),
                                   rtol=RTOL, atol=3.8 * 2 * ATOL * q_scale, err_msg=f"priorities {c}")
        for a, b in zip(tdqn.tree_leaves(states["kd"][0]), tdqn.tree_leaves(states["rm"][0])):
            assert_f32_close(a.numpy(), b.numpy(), f"params {c}")


VALIDATION = {
    "short_n_steps": (dict(n_steps=3), dict(kernel_insert=True), "n_steps"),
    "with_kernel_act_rollout": ({}, dict(kernel_insert=True, kernel_act_rollout=True), "subsumes"),
    "not_per": (dict(per=False), dict(kernel_insert=True), "PER"),
    "not_noisy": (dict(noisy=False), dict(kernel_insert=True), "noisy"),
    "two_hidden_layers": (dict(hidden_sizes=(64, 64)), dict(kernel_insert=True), "one hidden layer"),
    "games_not_a_tile_multiple": ({}, dict(kernel_insert=True, num_games=100), "num_games"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_kernel_insert_validation(case):
    """Config validation of the K5 path (JAX tests/test_act_rollout.py:273-287)."""
    overrides, options, match = VALIDATION[case]
    td = tdqn.DQNConfig(**dict(FLAGSHIP, **overrides))
    options = dict(options)
    num_games = options.pop("num_games", KD_G)
    with pytest.raises(ValueError, match=match):
        tvec.make_dqn_selfplay_step(EnvConfig(4), td, tdqn.Adam(), num_games, device="cpu", **options)
