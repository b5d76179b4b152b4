"""ACER on the port against the JAX package: the heads, the retrace
recursion, both train steps, the self-play rollout and cycle, the sequence
buffer, the host agent and the host buffers.

Randomness is replayed from the JAX keys in JAX's split order (see
``test_torch_reinforce.py``): a cycle splits ``roll_key, sample_key``, the
rollout draws its decks and Gumbel noise from ``roll_key``, the on-policy
subsample is ``choice(fold_in(sample_key, 1), G*P, (k,), replace=False)`` and
the off-policy sample ``randint(sample_key, (minibatch,), 0, size)``.
Tolerances as there: integer outputs bit for bit, float32 values rtol 1e-5,
atol 1e-6 times the largest magnitude, parameters compared after SGD updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl6nimmt_tpu.agents import acer as jacer
from rl6nimmt_tpu.buffers import host as jhost
from rl6nimmt_tpu.buffers import sequence as jseq
from rl6nimmt_tpu.engine import EnvConfig as JaxConfig
from rl6nimmt_tpu.nets import MLPSpec as JMLPSpec
from rl6nimmt_tpu.nets import mlp_init as jmlp_init
from rl6nimmt_tpu.runtime import vector as jvec
from rl6nimmt_torch.agents import acer as tacer
from rl6nimmt_torch.agents.dqn import Adam, Sgd, tree_leaves
from rl6nimmt_torch.buffers import host as thost
from rl6nimmt_torch.buffers import sequence as tseq
from rl6nimmt_torch.buffers import sumtree_native
from rl6nimmt_torch.engine import EnvConfig
from rl6nimmt_torch.nets import MLPSpec, mlp_init, params_from_jax, params_to_numpy
from rl6nimmt_torch.runtime import vector as tvec

RTOL, ATOL = 1e-5, 1e-6
G, HIDDEN = 8, (16, 16)
JCFG, CFG = JaxConfig(4), EnvConfig(4)
FIELDS = ("state", "legal_cards", "log_probs", "action_id", "reward", "done")


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


def _specs(hidden=HIDDEN):
    return (JMLPSpec(JCFG.state_length + 1, hidden_sizes=hidden, head_sizes=(1, 1)),
            MLPSpec(CFG.state_length + 1, hidden_sizes=hidden, head_sizes=(1, 1)))


def _jax_example():
    return {"state": jnp.zeros(47), "legal_cards": jnp.zeros(10, jnp.int32), "log_probs": jnp.zeros(10),
            "action_id": jnp.zeros((), jnp.int32), "reward": jnp.zeros(()), "done": jnp.zeros(())}


def replay_rollout(key, num_games, cfg=JCFG):
    """The decks and Gumbel noise one JAX rollout draws from ``key``."""
    key, deal_key = jax.random.split(key)
    decks = jax.vmap(lambda k: jax.random.permutation(k, cfg.num_cards))(jax.random.split(deal_key, num_games))
    gumbel = []
    for _ in range(cfg.max_turns):
        key, sub = jax.random.split(key)
        gumbel.append(np.asarray(jax.random.gumbel(sub, (num_games, cfg.num_players, cfg.hand_size))))
    return tvec.RolloutRandomness(gumbel=torch.tensor(np.stack(gumbel)), decks=torch.tensor(np.asarray(decks)))


def replay_cycle(key, num_games, minibatch, k_on, size_after_store):
    """The randomness one JAX ACER cycle draws from ``key``."""
    roll_key, sample_key = jax.random.split(key)
    n_fresh = num_games * JCFG.num_players
    on_idx = None
    if k_on < n_fresh:
        on_idx = torch.tensor(np.asarray(
            jax.random.choice(jax.random.fold_in(sample_key, 1), n_fresh, (k_on,), replace=False)))
    off_idx = torch.tensor(np.asarray(jax.random.randint(sample_key, (minibatch,), 0, max(size_after_store, 1))))
    return tvec.AcerRandomness(rollout=replay_rollout(roll_key, num_games), off_idx=off_idx, on_idx=on_idx)


def _batch(rng, B, aligned, lengths=None):
    """A random ``[B, T]`` ACER batch; ``aligned``: step t's cards in the leading H - t slots."""
    T = H = 10
    cards = np.full((B, T, H), -1, np.int32)
    for b in range(B):
        hand = np.sort(rng.choice(104, size=H, replace=False))
        for t in range(T):
            cards[b, t, : H - t] = hand[t:] if aligned else np.sort(rng.choice(104, H - t, replace=False))
    logits = rng.randn(B, T, H).astype(np.float32)
    logits = np.where(cards >= 0, logits, -np.inf)
    log_probs = np.where(cards >= 0, logits - np.log(np.exp(logits).sum(-1, keepdims=True)), -20.0)
    return {
        "state": rng.randn(B, T, 47).astype(np.float32) * 5,
        "legal_cards": cards,
        "log_probs": log_probs.astype(np.float32),
        "action_id": np.stack([[rng.randint(0, H - t) for t in range(T)] for _ in range(B)]).astype(np.int32),
        "reward": rng.randn(B, T).astype(np.float32),
        "done": (rng.random((B, T)) < 0.1).astype(np.float32),
        "length": np.full(B, T, np.int32) if lengths is None else np.asarray(lengths, np.int32),
    }


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ------------------------------------------------------------------ math


def test_actor_critic_heads_match_jax():
    jspec, tspec = _specs()
    jparams = jmlp_init(jax.random.key(0), jspec)
    rng = np.random.RandomState(1)
    b = _batch(rng, 3, aligned=False)
    lp, q = tacer.actor_critic_heads(tspec, params_from_jax(_np(jparams), "cpu"),
                                     torch.from_numpy(b["state"]), torch.from_numpy(b["legal_cards"]))
    jlp, jq = jax.vmap(jax.vmap(lambda s, c: jacer.actor_critic_heads(jspec, jparams, s, c)))(
        b["state"], b["legal_cards"])
    assert_f32_close(lp.numpy(), jlp)
    assert_f32_close(q.numpy(), jq)
    pad = b["legal_cards"] < 0
    assert (lp.numpy()[pad] == tacer.LOG_EPSILON).all() and (q.numpy()[pad] == 0).all()


def test_acer_qret_matches_jax_with_lengths():
    rng = np.random.RandomState(2)
    B, T = 5, 10
    args = [rng.randn(B, T).astype(np.float32) for _ in range(5)]
    args[1] = (rng.random((B, T)) < 0.3).astype(np.float32)        # dones
    args[4] = np.minimum(np.exp(rng.randn(B, T)), 1.0).astype(np.float32)   # rho_bar
    lengths = np.asarray([10, 1, 4, 7, 9], np.int32)
    got = tacer.acer_qret(*(torch.from_numpy(a) for a in args), torch.from_numpy(lengths), 0.99).numpy()
    want = jax.vmap(lambda r, d, qa, v, rb, ln: jacer.acer_qret(r, d, qa, v, rb, ln, 0.99))(*args, lengths)
    assert_f32_close(got, want)
    assert (got[np.arange(T)[None, :] >= lengths[:, None]] == 0).all()


@pytest.mark.parametrize("packed", [False, True], ids=["default", "packed"])
def test_acer_train_step_matches_jax(packed):
    """Mirrors tests/test_acer_math.py: the default step on variable-length
    padded sequences (lengths 10, 4, 7), the packed one on aligned full
    episodes; losses and params after two SGD updates."""
    jspec, tspec = _specs()
    jparams = jmlp_init(jax.random.key(0), jspec)
    tparams = params_from_jax(_np(jparams), "cpu")
    rng = np.random.RandomState(3)
    batch = _batch(rng, 6, aligned=True) if packed else _batch(rng, 3, aligned=False, lengths=[10, 4, 7])
    jopt = optax.sgd(1e-2)
    jtrain = jax.jit(jacer.make_acer_train_step(jspec, jopt, packed_rows=packed))
    ttrain = tacer.make_acer_train_step(tspec, Sgd(1e-2), packed_rows=packed)
    jstate, tstate = jopt.init(jparams), None
    for i in range(2):
        jparams, jstate, jl = jtrain(jparams, jstate, batch)
        tparams, tstate, tl = ttrain(tparams, tstate, _t(batch))
        for a, b, name in zip(tl, jl, ("actor", "correction", "critic")):
            assert_f32_close(a.numpy(), b, f"{name} {i}")
        _assert_params(tparams, jparams, f"params {i}")


def test_port_packed_step_matches_port_default_step():
    """Mirrors tests/test_acer_math.py::test_packed_train_step_matches_default_on_aligned_sequences."""
    _, tspec = _specs(hidden=(16,))
    params = mlp_init(torch.Generator().manual_seed(0), tspec, "cpu")
    batch = _t(_batch(np.random.RandomState(3), 6, aligned=True))
    outs = [tacer.make_acer_train_step(tspec, Sgd(1e-2), packed_rows=p)(params, None, batch) for p in (False, True)]
    for a, b in zip(outs[0][2], outs[1][2]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-7)
    for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------- rollout, cycle


def test_acer_rollout_bit_exact_and_folds_one_seat_per_sequence():
    """Mirrors tests/test_vector_runtime.py::test_acer_rollout_folds_one_seat_per_sequence."""
    jspec, tspec = _specs()
    jparams = jmlp_init(jax.random.key(50), jspec)
    key = jax.random.key(51)
    jseqs, jscores = jax.jit(jvec.make_acer_rollout(JCFG, jspec, G, r_factor=1.0))(jparams, key)
    seqs, scores = tvec.make_acer_rollout(CFG, tspec, G, 1.0, device="cpu")(
        params_from_jax(_np(jparams), "cpu"), replay_rollout(key, G))
    for k in ("state", "legal_cards", "action_id", "reward", "done", "length"):
        np.testing.assert_array_equal(seqs[k].numpy(), np.asarray(jseqs[k]), err_msg=k)
    assert_f32_close(seqs["log_probs"].numpy(), jseqs["log_probs"])
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    P, T = CFG.num_players, CFG.max_turns
    done = seqs["done"].numpy()
    assert (done[:, :-1] == 0).all() and (done[:, -1] == 1).all()
    np.testing.assert_array_equal(seqs["reward"].numpy().reshape(G, P, T).sum(axis=2), scores.numpy())
    legal = (seqs["legal_cards"].numpy() >= 0).sum(axis=2)
    np.testing.assert_array_equal(legal, np.tile(np.arange(T, 0, -1), (G * P, 1)))


CYCLES = [("all_fresh", 512, False, "sgd"), ("subsampled", 12, False, "sgd"), ("packed_subsampled_adam", 12, True, "adam")]


@pytest.mark.parametrize("label,on_policy,packed,opt", CYCLES, ids=[c[0] for c in CYCLES])
def test_acer_selfplay_cycle_matches_jax(label, on_policy, packed, opt):
    """Two cycles on replayed keys (mirrors tests/test_vector_runtime.py
    ::test_acer_selfplay_step and ::test_acer_on_policy_subsample): the
    sequence buffer, the six metrics and (SGD) the params; with G*P = 32 fresh
    sequences, 512 clamps to all-fresh and 12 subsamples."""
    jspec, tspec = _specs()
    jopt, topt = (optax.sgd(1e-2), Sgd(1e-2)) if opt == "sgd" else (optax.adam(1e-3), Adam(1e-3))
    jparams = jmlp_init(jax.random.key(20), jspec)
    tparams = params_from_jax(_np(jparams), "cpu")
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    cap, mb = 48, 16          # the second cycle's store wraps the ring
    jbuf = jseq.seq_init(cap, 10, _jax_example())
    tbuf = tseq.seq_init(cap, 10, tvec.acer_sequence_example(CFG), device="cpu")
    jcycle = jvec.make_acer_selfplay_step(JCFG, jspec, jopt, G, minibatch=mb, on_policy_sequences=on_policy,
                                          packed_rows=packed)
    tcycle = tvec.make_acer_selfplay_step(CFG, tspec, topt, G, minibatch=mb, on_policy_sequences=on_policy,
                                          packed_rows=packed, device="cpu")
    n_fresh = G * CFG.num_players
    for c, key in enumerate(jax.random.split(jax.random.key(21), 2)):
        rnd = replay_cycle(key, G, mb, min(on_policy, n_fresh), min((c + 1) * n_fresh, cap))
        jparams, jstate, jbuf, jm = jcycle(jparams, jstate, jbuf, key)
        tparams, tstate, tbuf, tm = tcycle(tparams, tstate, tbuf, rnd)
        for k in FIELDS:
            if k == "log_probs":
                assert_f32_close(tbuf.storage[k].numpy(), jbuf.storage[k], f"{k} {c}")
            else:
                np.testing.assert_array_equal(tbuf.storage[k].numpy(), np.asarray(jbuf.storage[k]), f"{k} {c}")
        np.testing.assert_array_equal(tbuf.seq_len.numpy(), np.asarray(jbuf.seq_len))
        assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size))
        assert set(tm) == set(jm)
        assert float(tm["mean_score"]) == float(jm["mean_score"])
        for k in tm:
            assert_f32_close(tm[k].numpy(), jm[k], f"{k} cycle {c}")
        if c == 0:
            # On-policy before the first update rho == 1, so the correction term vanishes.
            assert abs(float(tm["correction_loss"])) < 1e-5
        if opt == "sgd":
            _assert_params(tparams, jparams, f"params cycle {c}")


# ---------------------------------------------------------------- buffers


def test_sequence_buffer_matches_jax_through_a_wrap():
    """Mirrors tests/test_buffers.py::test_sequence_buffer_flush_and_first_flags,
    through a wrap of the ring and the capacity error."""
    ex = {"r": jnp.zeros(()), "a": jnp.zeros((3,), jnp.int32)}
    tex = {"r": torch.zeros(()), "a": torch.zeros(3, dtype=torch.int32)}
    js, ts = jseq.seq_init(4, 5, ex), tseq.seq_init(4, 5, tex, device="cpu")
    rng = np.random.RandomState(0)

    def same(what):
        for k in ("r", "a"):
            np.testing.assert_array_equal(ts.storage[k].numpy(), np.asarray(js.storage[k]), f"{what} {k}")
            np.testing.assert_array_equal(ts.current[k].numpy(), np.asarray(js.current[k]), f"{what} current {k}")
        np.testing.assert_array_equal(ts.seq_len.numpy(), np.asarray(js.seq_len))
        assert (ts.ptr, ts.size, ts.cur_len) == (int(js.ptr), int(js.size), int(js.cur_len)), what

    for n in (3, 5, 1):
        for _ in range(n):
            item = {"r": np.float32(rng.randn()), "a": rng.randint(0, 9, 3).astype(np.int32)}
            js = jseq.seq_store(js, item)
            ts = tseq.seq_store(ts, {k: torch.tensor(v) for k, v in item.items()})
        same(f"store {n}")
        js, ts = jseq.seq_flush(js), tseq.seq_flush(ts)
        same(f"flush {n}")
    with pytest.raises(ValueError, match="full"):
        for _ in range(6):
            tseq.seq_store(ts, {"r": torch.tensor(1.0), "a": torch.ones(3, dtype=torch.int32)})
    ts.cur_len = 0
    ts.current["r"].zero_()
    ts.current["a"].zero_()
    batch = {"r": rng.randn(3, 5).astype(np.float32), "a": rng.randint(0, 9, (3, 5, 3)).astype(np.int32)}
    lengths = np.asarray([5, 2, 4], np.int32)
    js = jseq.seq_store_batch(js, batch, lengths)              # slots 3, 0, 1: wraps
    ts = tseq.seq_store_batch(ts, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(lengths))
    same("store_batch")
    (jlast, jlen), (tlast, tlen) = jseq.seq_latest(js), tseq.seq_latest(ts)
    assert int(tlen) == int(jlen) == 4
    for k in ("r", "a"):
        np.testing.assert_array_equal(tlast[k].numpy(), np.asarray(jlast[k]))
    key = jax.random.key(3)
    jidx, jb, jlen = jseq.seq_sample(js, key, 7)
    tidx, tb, tlen = tseq.seq_sample(ts, 7, idx=torch.tensor(np.asarray(
        jax.random.randint(key, (7,), 0, max(int(js.size), 1)))))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    for k in ("r", "a"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    for bad in (torch.tensor([0, 4, 1, 1, 1, 1, 1]), torch.tensor([-1] * 7), torch.zeros(6, dtype=torch.int64)):
        with pytest.raises(ValueError, match="indices"):
            tseq.seq_sample(ts, 7, idx=bad)
    drawn = tseq.seq_sample(ts, 64, generator=torch.Generator().manual_seed(0))[0]
    assert drawn.min() >= 0 and drawn.max() < ts.size
    with pytest.raises(ValueError, match="exceeds buffer capacity"):
        jseq.seq_store_batch(js, {k: np.zeros((5,) + v.shape[1:], v.dtype) for k, v in batch.items()},
                             np.zeros(5, np.int32))
    with pytest.raises(ValueError, match="exceeds buffer capacity"):
        tseq.seq_store_batch(ts, {k: torch.zeros((5,) + v.shape[1:], dtype=v.dtype) for k, v in ts.current.items()},
                             torch.zeros(5, dtype=torch.int32))


def test_host_buffers_match_jax():
    """HostHistory, HostSequentialHistory and HostPriorityBuffer on one
    ``np.random`` seed give the JAX copies' records, indices and weights."""
    out = {}
    for name, mod in (("jax", jhost), ("port", thost)):
        np.random.seed(5)
        hist, seq, per = mod.HostHistory(max_length=6), mod.HostSequentialHistory(max_length=3), \
            mod.HostPriorityBuffer(16)
        for i in range(9):
            hist.store(x=i, y=-i)
            seq.store(s=i)
            if i % 2:
                seq.flush()
            per.store(x=float(i))
        idx, _, batch = hist.sample(4)
        sidx, _, sbatch = seq.sample(2)
        pidx, weights, pbatch = per.sample(5)
        per.batch_update(pidx, np.linspace(0.0, 2.0, 5))
        pidx2, weights2, _ = per.sample(5)
        out[name] = (idx, batch, hist.rollout(2), sidx, sbatch, seq.rollout(1), seq.current_sequence,
                     pidx, weights, pbatch, per.priorities.copy(), pidx2, weights2, per.beta, len(per))
    for a, b in zip(out["port"], out["jax"]):
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(a, b, rtol=1e-12)
        else:
            assert a == b


def _native():
    try:
        sumtree_native.library()
    except OSError as err:
        pytest.skip(f"the native sampler does not build here: {err}")
    return sumtree_native


def test_native_sampler_matches_numpy():
    """Mirrors tests/test_native.py on the port's binding (built into rl6nimmt_torch/_build/)."""
    sn = _native()
    assert str(sn.build()).startswith(str(sn.BUILD_ROOT))
    rng = np.random.RandomState(0)
    pri = rng.random(5000)
    for k in (1, 16, 257):
        u = (np.arange(k) + rng.random(k)) * (pri.sum() / k)
        np.testing.assert_array_equal(sn.stratified_sample(pri, u), np.searchsorted(np.cumsum(pri), u, side="left"))
    np.testing.assert_array_equal(sn.stratified_sample(np.asarray([1.0, 2.0, 3.0]), np.asarray([0.5, 5.9, 100.0])),
                                  [0, 2, 2])
    pri = np.zeros(8)
    sn.update_priorities(pri, np.asarray([0, 3]), np.asarray([0.5, 10.0]), 0.01, 1.0, 0.6)
    np.testing.assert_allclose(pri[[0, 3]], [0.51 ** 0.6, 1.0])
    assert sn.max_priority(pri, 8) == 1.0
    with pytest.raises(IndexError):
        sn.update_priorities(pri, np.asarray([8]), np.asarray([0.5]), 0.01, 1.0, 0.6)


# ------------------------------------------------------------- host agent


def test_acer_agent_learn_matches_jax():
    """Mirrors tests/test_agents.py::test_acer_learns_after_warmup on recorded
    steps: the warmup and flush cadence (rollout_len 4, so episodes of 10 flush
    at 4, 8 and the end), the on- and off-policy losses (the off-policy
    minibatch from ``np.random`` on one seed) and the params after SGD updates;
    and the forward's heads."""
    kw = dict(hidden_sizes=HIDDEN, warmup=2, minibatch=2, rollout_len=4, seed=0)
    jagent, tagent = jacer.BatchedACERAgent(**kw), tacer.BatchedACERAgent(device="cpu", **kw)
    tagent.set_parameters(params_from_jax(_np(jagent.parameters()), "cpu"))
    for a in (jagent, tagent):
        a.train()
    jagent.optimizer, tagent.optimizer = optax.sgd(1e-2), Sgd(1e-2)
    jagent.opt_state, tagent.opt_state = jagent.optimizer.init(jagent.params), None
    jagent._train_step = jax.jit(jagent._make_train_step())
    rng = np.random.RandomState(7)
    steps = []
    for e in range(2):
        for t in range(10):
            legal = sorted(rng.choice(104, 10 - t, replace=False).tolist())
            state = rng.randint(-1, 104, size=47).astype(np.float32)
            logp = np.log(rng.dirichlet(np.ones(10))).astype(np.float32)
            steps.append(dict(state=state, reward=0.0, action=legal[0], done=t == 9, next_state=state,
                              next_reward=-float(rng.randint(0, 6)), episode_end=t == 9, num_episode=e,
                              legal_actions=legal, log_probs=logp, action_id=int(rng.randint(0, 10 - t))))
    outs = {}
    for name, agent in (("jax", jagent), ("port", tagent)):
        np.random.seed(9)
        outs[name] = [agent.learn(**s) for s in steps]
    learned = [i for i, o in enumerate(outs["port"]) if o is not None]
    assert learned == [i for i, o in enumerate(outs["jax"]) if o is not None] and len(learned) >= 2
    for i in learned:
        for tl, jl in zip(outs["port"][i], outs["jax"][i]):
            assert_f32_close(tl, jl, f"losses at step {i}")
    _assert_params(tagent.parameters(), jagent.parameters(), "params")
    legal = steps[3]["legal_actions"]
    action, info = tagent.forward(steps[3]["state"], legal)
    _, jinfo = jagent.forward(steps[3]["state"], legal)
    assert action == legal[info["action_id"]]
    assert_f32_close(info["log_probs"], jinfo["log_probs"])
    assert_f32_close(info["values"], jinfo["values"])
