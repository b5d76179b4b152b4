"""The feature-major and block-aligned replay layouts: port vs JAX.

Buffers: ``per_init_fm`` with ``per_add_batch(slot_axis=-1)`` and
``per_init_aligned(_fm)`` with ``per_add_batch_aligned`` against JAX's on the
same numpy inputs, several inserts past capacity: storage, ``ptr`` and
``size`` bit-exact, priorities at ``tests/test_torch_buffers.py``'s tolerance
(rtol 1e-5, atol 1e-6), ``per_sample`` on JAX's uniforms drawing the same
slots.  The cycle: ``feature_major=True`` with the engine rollout (through
``row_major_to_fm``) against JAX's feature-major cycle on its replayed key
schedule, at ``tests/test_torch_dqn_cycle.py``'s tolerances.  JAX's K4 with
``feature_major=True`` runs only on a TPU (its deals use the TPU's hardware
PRNG), so the port's feature-major twin is held to its row-major twin
permuted, and its cycle to the row-major K4 cycle's transition multiset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl6nimmt_tpu.agents import dqn as jdqn_mod
from rl6nimmt_tpu.buffers import per as jper
from rl6nimmt_tpu.engine import EnvConfig as JaxConfig
from rl6nimmt_tpu.nets import mlp_init as jax_mlp_init
from rl6nimmt_tpu.runtime import vector as jvec
from rl6nimmt_torch.agents import dqn as tdqn
from rl6nimmt_torch.buffers import per as tper
from rl6nimmt_torch.engine import EnvConfig
from rl6nimmt_torch.nets import mlp_init, params_from_jax, params_to_numpy
from rl6nimmt_torch.ops.act_rollout_kernel import act_rollout_fm_plain, act_rollout_plain, make_act_rollout_kernel
from rl6nimmt_torch.runtime import vector as tvec
from test_torch_dqn_cycle import FLAGSHIP, _replay_jax_schedule, assert_f32_close

RTOL, ATOL = 1e-5, 1e-6
G, ITERS = 8, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _example():
    return {"state": np.zeros(5, np.int8), "action": np.zeros((), np.int32),
            "reward": np.zeros((), np.float32)}


def _items(rng, n, fm):
    rows = {"state": rng.randint(-1, 100, size=(n, 5)).astype(np.int8),
            "action": rng.randint(0, 104, size=n).astype(np.int32),
            "reward": rng.randn(n).astype(np.float32)}
    if fm:
        rows["state"] = np.ascontiguousarray(rows["state"].T)
    return rows


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _assert_same(js, ts, what=""):
    for k in js.storage:
        np.testing.assert_array_equal(ts.storage[k].numpy(), np.asarray(js.storage[k]), err_msg=f"{k} {what}")
    np.testing.assert_array_equal(ts.priorities.numpy() > 0, np.asarray(js.priorities) > 0, err_msg=what)
    np.testing.assert_allclose(ts.priorities.numpy(), np.asarray(js.priorities), rtol=RTOL, atol=ATOL,
                               err_msg=what)
    assert (ts.ptr, ts.size) == (int(js.ptr), int(js.size)), what
    np.testing.assert_allclose(float(ts.beta), float(js.beta), rtol=RTOL)


def _sample_and_update(js, ts, key, n, slot_axis, rng):
    """One per_sample on JAX's uniforms of ``key`` and one per_update on both."""
    u = np.asarray(jax.random.uniform(key, (n,)))
    js, jidx, jw, jbatch = jper.per_sample(js, key, n, slot_axis=slot_axis)
    ts, tidx, tw, tbatch = tper.per_sample(ts, torch.tensor(u), n, slot_axis=slot_axis)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL, atol=ATOL)
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]))
    err = rng.randn(n).astype(np.float32)
    return jper.per_update(js, jidx, jnp.asarray(err)), tper.per_update(ts, tidx, torch.tensor(err))


def test_per_fm_matches_jax():
    """per_init_fm + per_add_batch(slot_axis=-1): 5 inserts of 24 into 64 slots
    (the second on wraps), a sample and an update after each."""
    cap, n = 64, 24
    js = jper.per_init_fm(cap, _jax(_example()))
    ts = tper.per_init_fm(cap, _torch(_example()), device="cpu")
    assert ts.storage["state"].shape == (5, cap) and ts.storage["action"].shape == (cap,)
    rng, key = np.random.RandomState(11), jax.random.key(12)
    for it in range(5):
        items = _items(rng, n, fm=True)
        js = jper.per_add_batch(js, _jax(items), slot_axis=-1)
        ts = tper.per_add_batch(ts, _torch(items), slot_axis=-1)
        _assert_same(js, ts, f"insert {it}")
        key, sk = jax.random.split(key)
        js, ts = _sample_and_update(js, ts, sk, 8, -1, rng)
        _assert_same(js, ts, f"update {it}")


@pytest.mark.parametrize("fm", [False, True], ids=["row_major", "feature_major"])
def test_per_aligned_matches_jax(fm):
    """per_init_aligned(_fm) + per_add_batch_aligned: logical 10, block 8, so
    physical 16 and 6 stale slots evicted at every insert; 7 inserts, a sample
    and an update after each."""
    cap, n = 10, 8
    init_j = jper.per_init_aligned_fm if fm else jper.per_init_aligned
    init_t = tper.per_init_aligned_fm if fm else tper.per_init_aligned
    axis = -1 if fm else 0
    js = init_j(cap, n, _jax(_example()))
    ts = init_t(cap, n, _torch(_example()), device="cpu")
    assert ts.capacity == 16
    rng, key = np.random.RandomState(5), jax.random.key(6)
    for it in range(7):
        items = _items(rng, n, fm)
        js = jper.per_add_batch_aligned(js, _jax(items), cap, slot_axis=axis)
        ts = tper.per_add_batch_aligned(ts, _torch(items), cap, slot_axis=axis)
        _assert_same(js, ts, f"insert {it}")
        assert int((ts.priorities > 0).sum()) == min((it + 1) * n, cap)
        key, sk = jax.random.split(key)
        js, ts = _sample_and_update(js, ts, sk, 6, axis, rng)
        _assert_same(js, ts, f"update {it}")


def test_per_aligned_matches_ring_live_set():
    """The port's aligned buffer holds the ring's (row, priority) live set,
    round after round, with priority updates addressed by content (the twin
    of JAX's tests/test_buffers.py test of the same name)."""
    cap, n = 10, 8
    ex = {"x": torch.zeros(())}
    ring = tper.per_init(cap, ex, device="cpu")
    ali = tper.per_init_aligned(cap, n, ex, device="cpu")

    def live(state):
        mask = state.priorities > 0
        return dict(zip(state.storage["x"][mask].tolist(), state.priorities[mask].tolist()))

    def update_by_content(state):
        xs = state.storage["x"]
        sel = (state.priorities > 0) & (xs.long() % 3 == 0)
        idx = torch.nonzero(sel)[:, 0]
        return tper.per_update(state, idx, 0.05 + (xs[sel] % 7.0) / 10.0) if len(idx) else state

    rid = 0
    for _ in range(7):
        items = {"x": torch.arange(rid, rid + n, dtype=torch.float32)}
        rid += n
        ring = update_by_content(tper.per_add_batch(ring, items))
        ali = update_by_content(tper.per_add_batch_aligned(ali, items, cap))
        assert live(ring) == live(ali)
        assert len(live(ali)) == ring.size == ali.size == min(rid, cap)
        np.testing.assert_allclose(float(ring.priorities.sum()), float(ali.priorities.sum()), rtol=1e-6)


def test_per_aligned_sampling_live_and_tracks_priorities():
    """Aligned sampling never draws a stale slot, and one boosted row is drawn
    in proportion to its priority (the twin of JAX's test of the same name,
    on uniforms from a seeded generator)."""
    cap, n = 12, 8
    state = tper.per_init_aligned(cap, n, {"x": torch.zeros(())}, device="cpu")
    for r in range(3):
        state = tper.per_add_batch_aligned(state, {"x": torch.arange(r * n, (r + 1) * n, dtype=torch.float32)}, cap)
    pri = state.priorities
    assert int((pri > 0).sum()) == cap
    target = int(torch.nonzero((pri > 0) & (state.storage["x"] == 20.0))[0, 0])
    new_pri = torch.where(pri > 0, 0.1, 0.0)
    new_pri[target] = 8.0
    state.priorities.copy_(new_pri)
    gen = torch.Generator().manual_seed(2)
    counts = torch.zeros(16)
    for _ in range(200):
        _, idx, weights, _ = tper.per_sample(state, torch.rand(8, generator=gen), 8)
        assert bool((state.priorities[idx] > 0).all()) and bool(torch.isfinite(weights).all())
        counts += torch.bincount(idx, minlength=16)
    assert abs(float(counts[target] / counts.sum()) - 8.0 / (8.0 + 0.1 * (cap - 1))) < 0.05


@pytest.mark.parametrize("n,block,match", [(5, 8, "multiple of the insert block"),
                                           (4, 8, "capacity..capacity\\+block"),
                                           (8, 0, "insert_block must be positive")])
def test_per_aligned_validates_shapes(n, block, match):
    """JAX's errors: 16 % 5 != 0; 16 % 4 == 0 but 16 >= 10 + 4; and a block of 0."""
    with pytest.raises(ValueError, match=match):
        state = tper.per_init_aligned(10, block, {"x": torch.zeros(())}, device="cpu")
        tper.per_add_batch_aligned(state, {"x": torch.zeros(n)}, 10)
    with pytest.raises(ValueError, match=match):
        state = jper.per_init_aligned(10, block, {"x": jnp.zeros(())})
        jper.per_add_batch_aligned(state, {"x": jnp.zeros(n)}, 10)


def test_per_fm_matches_row_major_buffer():
    """The port's fm buffer behaves as its row-major one: same priorities,
    same draws on the same uniforms, the same transitions transposed, the same
    write-back (the twin of JAX's test of the same name)."""
    cap = 64
    ex = {"state": torch.zeros(47), "action": torch.zeros((), dtype=torch.int32), "reward": torch.zeros(())}
    rm = tper.per_init(cap, ex, device="cpu")
    fm = tper.per_init_fm(cap, ex, device="cpu")
    rng = np.random.RandomState(11)
    for it in range(3):
        rows = {"state": torch.tensor(rng.randint(-1, 104, size=(24, 47)), dtype=torch.float32),
                "action": torch.tensor(rng.randint(0, 104, size=24), dtype=torch.int32),
                "reward": torch.tensor(rng.randn(24), dtype=torch.float32)}
        rm = tper.per_add_batch(rm, rows)
        fm = tper.per_add_batch(fm, dict(rows, state=rows["state"].T), slot_axis=-1)
        assert torch.equal(rm.priorities, fm.priorities) and (rm.ptr, rm.size) == (fm.ptr, fm.size)
        assert torch.equal(rm.storage["state"], fm.storage["state"].T)
        u = torch.tensor(rng.rand(8), dtype=torch.float32)
        rm, idx_rm, w_rm, b_rm = tper.per_sample(rm, u, 8)
        fm, idx_fm, w_fm, b_fm = tper.per_sample(fm, u, 8, slot_axis=-1)
        assert torch.equal(idx_rm, idx_fm) and torch.equal(w_rm, w_fm)
        assert torch.equal(b_rm["state"], b_fm["state"].T) and torch.equal(b_rm["reward"], b_fm["reward"])
        errs = torch.tensor(rng.rand(8), dtype=torch.float32)
        assert torch.equal(tper.per_update(rm, idx_rm, errs).priorities, tper.per_update(fm, idx_fm, errs).priorities)


# --------------------------------------------------------------- the cycle

FM_CAP = 500     # 320 transitions a cycle (T*G*P): the second cycle's insert wraps or evicts


@pytest.mark.parametrize("aligned", [False, True], ids=["fm", "aligned_fm"])
def test_fm_cycle_matches_jax(aligned):
    """The feature-major cycle on the engine rollout (``row_major_to_fm``)
    against JAX's feature-major cycle, 2 cycles on JAX's replayed keys: buffers
    bit-exact (n-step rewards and priorities at test_torch_dqn_cycle's
    tolerances), loss, mean score and params as there."""
    jcfg, cfg = JaxConfig(4), EnvConfig(4)
    jd, td = jdqn_mod.DQNConfig(**FLAGSHIP), tdqn.DQNConfig(**FLAGSHIP)
    jspec = jdqn_mod.q_network_spec(jd, 47, 104)
    tspec = tdqn.q_network_spec(td, 47, 104)
    opt = optax.adam(1e-3)
    jparams = jax_mlp_init(jax.random.key(20), jspec)
    jtarget = jax.tree.map(jnp.copy, jparams)
    jopt = opt.init(jparams)
    block = cfg.max_turns * G * cfg.num_players
    kw = dict(feature_major=True, per_aligned_capacity=FM_CAP if aligned else None)
    if aligned:
        jbuf = jper.per_init_aligned_fm(FM_CAP, block, jvec.dqn_replay_example(jcfg, compact=True))
        tbuf = tper.per_init_aligned_fm(FM_CAP, block, tvec.dqn_replay_example(cfg, compact=True), device="cpu")
    else:
        jbuf = jper.per_init_fm(FM_CAP, jvec.dqn_replay_example(jcfg, compact=True))
        tbuf = tper.per_init_fm(FM_CAP, tvec.dqn_replay_example(cfg, compact=True), device="cpu")
    jcycle = jvec.make_dqn_selfplay_step(jcfg, jd, opt, G, learn_iters=ITERS, **kw)
    adam = tdqn.Adam(1e-3)
    tp, tt = params_from_jax(_np(jparams), "cpu"), params_from_jax(_np(jtarget), "cpu")
    topt = adam.init(tp)
    tcycle = tvec.make_dqn_selfplay_step(cfg, td, adam, G, learn_iters=ITERS, device="cpu", **kw)
    for c, key in enumerate(jax.random.split(jax.random.key(43), 2)):
        rnd = _replay_jax_schedule(jcfg, jd, jspec, key, G, ITERS)
        jparams, jtarget, jopt, jbuf, jm = jcycle(jparams, jtarget, jopt, jbuf, key, jnp.asarray(0.0), c * ITERS)
        tp, tt, topt, tbuf, tm = tcycle(tp, tt, topt, tbuf, rnd, 0.0, c * ITERS)
        for k in ("state", "action", "next_state", "done"):
            np.testing.assert_array_equal(tbuf.storage[k].numpy(), np.asarray(jbuf.storage[k]),
                                          err_msg=f"{k} cycle {c}")
        assert_f32_close(tbuf.storage["reward"].numpy(), jbuf.storage["reward"], f"reward {c}")
        assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size))
        jpri = np.asarray(jbuf.priorities)
        np.testing.assert_array_equal(tbuf.priorities.numpy() > 0, jpri > 0)
        live = tbuf.storage["state"].T[tbuf.priorities > 0].float()
        q_scale = max(1.0, float(tdqn.q_values(td, tspec, tp, live).abs().max()))
        np.testing.assert_allclose(tbuf.priorities.numpy(), jpri, rtol=RTOL, atol=3.8 * 2 * ATOL * q_scale,
                                   err_msg=f"priorities {c}")
        assert float(tm["mean_score"]) == float(jm["mean_score"])
        assert_f32_close(tm["loss"].numpy(), jm["loss"], f"loss {c}")
        for a, b in zip(jax.tree.leaves(params_to_numpy(tp)), jax.tree.leaves(_np(jparams))):
            assert_f32_close(a, b, f"params cycle {c}")
    assert tbuf.size == FM_CAP


def test_to_transitions_fm_matches_row_major_harvest():
    """to_transitions_fm on row_major_to_fm's triple holds to_transitions'
    transitions in (t, p, g) order, at n_steps 1, 3 and 10."""
    cfg = EnvConfig(4)
    T, P, S = cfg.max_turns, cfg.num_players, cfg.state_length
    gen = torch.Generator().manual_seed(7)
    obs = torch.randint(-1, 104, (T, G, P, S), generator=gen).to(torch.int8)
    nxt = torch.cat([obs[1:], torch.randint(-1, 104, (1, G, P, S), generator=gen).to(torch.int8)])
    actions = torch.randint(0, 104, (T, G, P), generator=gen).to(torch.int32)
    rewards = torch.randint(-7, 1, (T, G, P), generator=gen).to(torch.float32)
    for n in (1, 3, 10):
        rm = tvec.to_transitions(cfg, 0.99, n, True, obs, actions, rewards, nxt)
        fm = tvec.to_transitions_fm(cfg, 0.99, n, True, *tvec.row_major_to_fm(obs, actions, rewards, nxt))
        for k, v in rm.items():
            want = v.reshape((T, G, P) + tuple(v.shape[1:])).permute(0, 2, 1, *range(3, v.dim() + 2))
            want = want.reshape((T * P * G,) + tuple(v.shape[1:]))
            got = fm[k].T if fm[k].dim() == 2 else fm[k]
            if k == "reward":
                assert_f32_close(got.numpy(), want.numpy(), f"reward n={n}")
            else:
                assert torch.equal(got, want.to(got.dtype)), f"{k} n={n}"


def test_k4_fm_twin_is_the_row_major_twin_permuted():
    """On CPU weights ``play`` of the feature-major K4 runs its twin: the
    row-major twin's games in [S, (T+1)*P, G] / [T*P, G], at a ragged G."""
    cfg = EnvConfig(4)
    T, P, S, g = cfg.max_turns, cfg.num_players, cfg.state_length, 5
    args = _k4_weights(cfg, 16)
    obs, act, rew = make_act_rollout_kernel(cfg, g, 16, feature_major=True)(3, *args)
    assert obs.shape == (S, (T + 1) * P, g) and act.shape == rew.shape == (T * P, g)
    ro, ra, rr = act_rollout_plain(cfg, 3, g, *args)
    assert torch.equal(obs.reshape(S, T + 1, P, g).permute(1, 3, 2, 0), ro)
    assert torch.equal(act.reshape(T, P, g).permute(0, 2, 1), ra)
    assert torch.equal(rew.reshape(T, P, g).permute(0, 2, 1), rr)
    for a, b in zip(act_rollout_fm_plain(cfg, 3, g, *args), (obs, act, rew)):
        assert torch.equal(a, b)


def _k4_weights(cfg, hidden):
    gen = torch.Generator().manual_seed(1)
    T, S, A = cfg.max_turns, cfg.state_length, cfg.num_actions
    return (torch.randn((T, S, hidden), generator=gen) * 0.1, torch.randn((T, hidden), generator=gen) * 0.1,
            torch.randn((T, hidden, A), generator=gen) * 0.1, torch.randn((T, A), generator=gen) * 0.1)


KERNEL_FLAGS = dict(FLAGSHIP, hidden_sizes=(16,), minibatch=16)


def test_kernel_fm_cycle_holds_the_row_major_transition_multiset():
    """The K4 cycle (twin on the CPU) in both layouts from one state and one
    randomness: the same transitions in (t, p, g) and (t, g, p) slot order, the
    same mean score, finite losses and moved params (JAX's
    test_feature_major_transition_multiset_matches_row_major)."""
    cfg, td = EnvConfig(4), tdqn.DQNConfig(**KERNEL_FLAGS)
    T, P = cfg.max_turns, cfg.num_players
    g = 16
    spec = tdqn.q_network_spec(td, 47, 104)
    params = mlp_init(torch.Generator().manual_seed(1), spec, device="cpu")
    adam = tdqn.Adam(1e-3)
    ex = tvec.dqn_replay_example(cfg)
    rnd = tvec.draw_cycle_randomness(cfg, td, g, ITERS, torch.Generator().manual_seed(5))
    out = {}
    for name, fm in (("rm", False), ("fm", True)):
        buf = (tper.per_init_fm if fm else tper.per_init)(4096, ex, device="cpu")
        cycle = tvec.make_dqn_selfplay_step(cfg, td, adam, g, learn_iters=ITERS, kernel_act_rollout=True,
                                            feature_major=fm, device="cpu")
        out[name] = cycle(params, params, adam.init(params), buf, rnd, 0.1)
    (p_rm, _, _, b_rm, m_rm), (p_fm, _, _, b_fm, m_fm) = out["rm"], out["fm"]
    assert bool(torch.isfinite(m_fm["loss"])) and float(m_rm["mean_score"]) == float(m_fm["mean_score"])
    assert any(not torch.equal(a, b) for a, b in zip(tdqn.tree_leaves(p_fm), tdqn.tree_leaves(params)))
    N = T * g * P
    assert b_rm.size == b_fm.size == N
    perm = torch.arange(N).reshape(T, g, P).permute(0, 2, 1).reshape(-1)    # fm slot -> rm slot
    for k in ("state", "next_state"):
        assert torch.equal(b_fm.storage[k][:, :N].T, b_rm.storage[k][:N][perm])
    for k in ("action", "done"):
        assert torch.equal(b_fm.storage[k][:N], b_rm.storage[k][:N][perm])
    assert_f32_close(b_fm.storage["reward"][:N].numpy(), b_rm.storage["reward"][:N][perm].numpy(), "reward")


@pytest.mark.parametrize("aligned", [False, True], ids=["fm", "aligned_fm"])
def test_kernel_fm_cycles_are_deterministic(aligned):
    """Three cycles, run twice from one state on the same randomness, end
    bit-identical (the eager counterpart of JAX's chained-vs-sequential guard),
    with the aligned buffer's size and ptr as the contract says."""
    cfg, td = EnvConfig(4), tdqn.DQNConfig(**KERNEL_FLAGS)
    g = 8
    block = cfg.max_turns * g * cfg.num_players
    spec = tdqn.q_network_spec(td, 47, 104)
    params = mlp_init(torch.Generator().manual_seed(60), spec, device="cpu")
    adam = tdqn.Adam(1e-3)
    ex = tvec.dqn_replay_example(cfg)
    cycle = tvec.make_dqn_selfplay_step(cfg, td, adam, g, learn_iters=ITERS, kernel_act_rollout=True,
                                        feature_major=True, per_aligned_capacity=FM_CAP if aligned else None,
                                        device="cpu")
    gen = torch.Generator().manual_seed(61)
    rnds = [tvec.draw_cycle_randomness(cfg, td, g, ITERS, gen) for _ in range(3)]
    runs = []
    for _ in range(2):
        buf = tper.per_init_aligned_fm(FM_CAP, block, ex, device="cpu") if aligned else \
            tper.per_init_fm(FM_CAP, ex, device="cpu")
        st = (params, params, adam.init(params), buf)
        for c, rnd in enumerate(rnds):
            *st, m = cycle(*st, rnd, 0.2, c * ITERS)
        runs.append(st)
    (p1, _, _, b1), (p2, _, _, b2) = runs
    assert all(torch.equal(a, b) for a, b in zip(tdqn.tree_leaves(p1), tdqn.tree_leaves(p2)))
    assert torch.equal(b1.priorities, b2.priorities)
    assert all(torch.equal(b1.storage[k], b2.storage[k]) for k in b1.storage)
    inserted = 3 * block
    phys = b1.capacity
    assert (b1.size, b1.ptr) == (min(inserted, FM_CAP), inserted % phys)
    assert int((b1.priorities > 0).sum()) == min(inserted, FM_CAP)


VALIDATION = {
    "fm_without_per": (dict(per=False), dict(feature_major=True), "PER"),
    "kernel_insert_with_fm": ({}, dict(kernel_insert=True, feature_major=True), "subsumes"),
    "kernel_insert_with_k4": ({}, dict(kernel_insert=True, kernel_act_rollout=True), "subsumes"),
    "fm_k4_not_noisy": (dict(noisy=False), dict(feature_major=True, kernel_act_rollout=True), "noisy"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_feature_major_validation(case):
    """The options' validation, as JAX's (runtime/vector.py:607-630,
    tests/test_vector_runtime.py::test_feature_major_validation); each error
    is also JAX's, where JAX checks the same case."""
    overrides, options, match = VALIDATION[case]
    td = tdqn.DQNConfig(**dict(FLAGSHIP, **overrides))
    with pytest.raises(ValueError, match=match):
        tvec.make_dqn_selfplay_step(EnvConfig(4), td, tdqn.Adam(), 128, device="cpu", **options)
    jd = jdqn_mod.DQNConfig(**dict(FLAGSHIP, **overrides))
    jax_options = {("pallas_act_rollout" if k == "kernel_act_rollout" else k): v for k, v in options.items()}
    with pytest.raises(ValueError, match=match):
        jvec.make_dqn_selfplay_step(JaxConfig(4), jd, optax.adam(1e-3), 128, **jax_options)


def test_dp_cycle_takes_the_fm_options(tmp_path):
    """``make_dp_dqn_step`` passes both options through: at gloo world size 1 a
    K4 feature-major cycle into an aligned buffer equals the plain one."""
    import torch.distributed as dist

    from rl6nimmt_torch.parallel import make_dp_dqn_step, make_mesh

    cfg, td = EnvConfig(4), tdqn.DQNConfig(**KERNEL_FLAGS)
    g = 8
    block = cfg.max_turns * g * cfg.num_players
    spec = tdqn.q_network_spec(td, 47, 104)
    params = mlp_init(torch.Generator().manual_seed(70), spec, device="cpu")
    adam = tdqn.Adam(1e-3)
    kw = dict(learn_iters=ITERS, kernel_act_rollout=True, feature_major=True, per_aligned_capacity=FM_CAP)
    fresh = lambda: (params, params, adam.init(params),
                     tper.per_init_aligned_fm(FM_CAP, block, tvec.dqn_replay_example(cfg), device="cpu"))
    plain = tvec.make_dqn_selfplay_step(cfg, td, adam, g, device="cpu", **kw)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1)
    try:
        dp = make_dp_dqn_step(cfg, td, adam, g, make_mesh(device="cpu"), **kw)
        outs = []
        for step in (plain, dp):
            st, gen = fresh(), torch.Generator().manual_seed(71)
            for c in range(2):
                *st, m = step(*st, gen, 0.0, c * ITERS)
            outs.append((st, m))
    finally:
        dist.destroy_process_group()
    (s1, m1), (s2, m2) = outs
    assert torch.equal(m1["loss"], m2["loss"]) and float(m1["mean_score"]) == float(m2["mean_score"])
    assert all(torch.equal(a, b) for a, b in zip(tdqn.tree_leaves(s1[0]), tdqn.tree_leaves(s2[0])))
    assert torch.equal(s1[3].priorities, s2[3].priorities) and (s1[3].ptr, s1[3].size) == (s2[3].ptr, s2[3].size)
