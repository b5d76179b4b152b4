"""Port ring/PER buffers vs the JAX buffers on the same inputs and uniforms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl6nimmt_tpu.buffers import per as jper
from rl6nimmt_tpu.buffers import ring as jring
from rl6nimmt_torch.buffers import per as tper
from rl6nimmt_torch.buffers import ring as tring

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("ptr,n", [(0, 5), (3, 5), (10, 6), (14, 16), (7, 16)])
def test_circular_write_matches_jax(ptr, n):
    """No-wrap (ptr + n <= cap) and wrap cases, in place on the port side."""
    cap = 16
    rng = np.random.RandomState(ptr * 31 + n)
    buf = rng.randint(0, 100, size=(cap, 3)).astype(np.int8)
    items = rng.randn(n, 3).astype(np.float32) * 10
    expect = np.asarray(jring.circular_write(jnp.asarray(buf), jnp.asarray(items), jnp.int32(ptr)))
    tbuf = torch.tensor(buf)
    out = tring.circular_write(tbuf, torch.tensor(items), ptr)
    assert out is tbuf                        # in place
    np.testing.assert_array_equal(tbuf.numpy(), expect)


def _example():
    return {"state": np.zeros(5, np.int8), "reward": np.zeros((), np.float32)}


def _items(rng, n):
    return {"state": rng.randint(-1, 100, size=(n, 5)).astype(np.int8),
            "reward": rng.randn(n).astype(np.float32)}


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _both_buffers(cap, inserts, seed=0):
    rng = np.random.RandomState(seed)
    js = jper.per_init(cap, {k: jnp.asarray(v) for k, v in _example().items()})
    ts = tper.per_init(cap, _t(_example()), device="cpu")
    for n in inserts:
        items = _items(rng, n)
        js = jper.per_add_batch(js, {k: jnp.asarray(v) for k, v in items.items()})
        ts = tper.per_add_batch(ts, _t(items))
    return js, ts


def _assert_same(js, ts):
    for k in js.storage:
        np.testing.assert_array_equal(np.asarray(js.storage[k]), ts.storage[k].numpy())
    np.testing.assert_allclose(ts.priorities.numpy(), np.asarray(js.priorities), rtol=RTOL, atol=ATOL)
    assert int(js.ptr) == ts.ptr and int(js.size) == ts.size
    np.testing.assert_allclose(float(ts.beta), float(js.beta), rtol=RTOL)


def test_per_add_batch_matches_jax_with_wrap():
    js, ts = _both_buffers(256, [100, 100, 100])   # third insert wraps
    _assert_same(js, ts)


@pytest.mark.parametrize("cap", [256, 2048])
def test_per_sample_update_cycle_matches_jax(cap):
    """Same uniforms -> same indices; weights and priorities allclose over
    several sample/update rounds (non-integer priorities after the first)."""
    js, ts = _both_buffers(cap, [cap // 2, cap // 3])
    key = jax.random.key(11)
    rng = np.random.RandomState(3)
    for it in range(4):
        key, sk = jax.random.split(key)
        u = np.asarray(jax.random.uniform(sk, (64,)))
        js, jidx, jw, jbatch = jper.per_sample(js, sk, 64)
        ts, tidx, tw, tbatch = tper.per_sample(ts, torch.tensor(u), 64)
        np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy(), err_msg=f"round {it}")
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL, atol=ATOL)
        for k in jbatch:
            np.testing.assert_array_equal(np.asarray(jbatch[k]), tbatch[k].numpy())
        err = rng.randn(64).astype(np.float32)
        js = jper.per_update(js, jidx, jnp.asarray(err))
        ts = tper.per_update(ts, tidx, torch.tensor(err))
        _assert_same(js, ts)


def test_per_update_duplicate_indices_last_write_wins():
    """A forced duplicate: the port keeps the LAST write, as JAX does on CPU."""
    js, ts = _both_buffers(256, [200])
    idx = np.array([5, 9, 5, 17, 9, 5], np.int32)
    err = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.05], np.float32)
    js = jper.per_update(js, jnp.asarray(idx), jnp.asarray(err))
    ts = tper.per_update(ts, torch.tensor(idx).long(), torch.tensor(err))
    _assert_same(js, ts)
    np.testing.assert_allclose(float(ts.priorities[5]), (0.05 + 0.01) ** 0.6, rtol=1e-6)
    np.testing.assert_allclose(float(ts.priorities[9]), (0.5 + 0.01) ** 0.6, rtol=1e-6)


def test_stratified_sample_draws_a_duplicate():
    """One dominant priority makes several strata land on one slot; the
    sampled indices (with the duplicate) and the update still match JAX."""
    js, ts = _both_buffers(256, [64])
    pri = np.asarray(js.priorities).copy()
    pri[7] = 50.0
    js = js._replace(priorities=jnp.asarray(pri))
    ts.priorities.copy_(torch.tensor(pri))
    key = jax.random.key(5)
    u = np.asarray(jax.random.uniform(key, (16,)))
    js, jidx, jw, _ = jper.per_sample(js, key, 16)
    ts, tidx, tw, _ = tper.per_sample(ts, torch.tensor(u), 16)
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    assert (tidx == 7).sum() > 1
    err = np.linspace(0.0, 0.9, 16).astype(np.float32)
    js = jper.per_update(js, jidx, jnp.asarray(err))
    ts = tper.per_update(ts, tidx, torch.tensor(err))
    _assert_same(js, ts)


def test_block_size_and_constants_match_jax():
    for cap in (10, 64, 4096, 5000, 200_000, 2_000_000):
        assert tper._block_size(cap) == jper._block_size(cap)
    for name in ("ABS_ERROR_UPPER", "EPSILON", "ALPHA", "BETA0", "BETA_INCREMENT"):
        assert getattr(tper, name) == getattr(jper, name)


def test_ring_add_and_sample():
    ts = tring.ring_init(8, _t(_example()), device="cpu")
    rng = np.random.RandomState(0)
    items = _items(rng, 6)
    ts = tring.ring_add_batch(ts, _t(items))
    ts = tring.ring_add_batch(ts, _t(items))
    assert (ts.ptr, ts.size) == (4, 8)
    np.testing.assert_array_equal(ts.storage["state"][:4].numpy(), items["state"][2:])
    idx, batch = tring.ring_sample(ts, torch.tensor([0.0, 0.5, 0.999]))
    assert idx.tolist() == [0, 4, 7]
    assert torch.equal(batch["state"], ts.storage["state"][idx])


# ------------------------------------------------------------- the kd layout


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_per_kd_sample_matches_jax():
    """kd planes sampled with the slot axis last (slot_axis=-1) after two
    marks: same indices, weights allclose, batches [rows, n] equal, and
    per_update bit-exact."""
    cap = 256
    rng = np.random.RandomState(4)
    planes = {"state": rng.randint(-1, 100, size=(48, cap)).astype(np.int8),
              "next_state": rng.randint(-1, 100, size=(48, cap)).astype(np.int8),
              "scalars": rng.randn(8, cap).astype(np.float32)}
    js = jper.per_init_kd(cap, 48, 8)._replace(storage=_j(planes))
    ts = tper.per_mark_batch(tper.per_init_kd(cap, 48, 8, device="cpu"), _t(planes), 100)
    js = jper.per_mark_batch(js, js.storage, 100)
    js = jper.per_mark_batch(js, js.storage, 100)
    ts = tper.per_mark_batch(ts, ts.storage, 100)
    key = jax.random.key(8)
    for it in range(3):
        key, sk = jax.random.split(key)
        u = np.asarray(jax.random.uniform(sk, (16,)))
        js, jidx, jw, jbatch = jper.per_sample(js, sk, 16, slot_axis=-1)
        ts, tidx, tw, tbatch = tper.per_sample(ts, torch.tensor(u), 16, slot_axis=-1)
        np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy(), err_msg=f"round {it}")
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL, atol=ATOL)
        assert tuple(tbatch["state"].shape) == (48, 16)
        for k in jbatch:
            np.testing.assert_array_equal(np.asarray(jbatch[k]), tbatch[k].numpy())
        err = rng.randn(16).astype(np.float32)
        js = jper.per_update(js, jidx, jnp.asarray(err))
        ts = tper.per_update(ts, tidx, torch.tensor(err))
        _assert_same(js, ts)


def test_per_kd_mark_batch_matches_jax():
    """kd planes: same shapes and dtypes; per_mark_batch's priorities, ptr and
    size bit-exact through wraps, with the same learned priorities written
    into both buffers between marks."""
    cap, n = 64, 24
    js = jper.per_init_kd(cap, 48, 8)
    ts = tper.per_init_kd(cap, 48, 8, device="cpu")
    for k in js.storage:
        assert tuple(ts.storage[k].shape) == js.storage[k].shape
        assert str(ts.storage[k].dtype).split(".")[-1] == str(js.storage[k].dtype)
    rng = np.random.RandomState(2)
    for r in range(4):
        js = jper.per_mark_batch(js, js.storage, n)
        ts = tper.per_mark_batch(ts, ts.storage, n)
        np.testing.assert_array_equal(ts.priorities.numpy(), np.asarray(js.priorities))
        assert (ts.ptr, ts.size) == (int(js.ptr), int(js.size))
        pri = np.asarray(js.priorities).copy()
        pri[rng.randint(0, ts.size, size=6)] = rng.rand(6).astype(np.float32) * (r + 1)
        js = js._replace(priorities=jnp.asarray(pri))
        ts.priorities.copy_(torch.tensor(pri))
    with pytest.raises(ValueError):
        tper.per_mark_batch(ts, ts.storage, cap + 1)


# ------------------------------------------------------- single-item adds


def test_ring_add_capacity_and_clear_match_jax():
    """``tests/test_buffers.py``'s wraparound on both packages: six single adds
    into four slots overwrite slots 0 and 1; ``ring_clear`` empties the ring
    and keeps the storage, as JAX's."""
    js = jring.ring_init(4, _j(_example()))
    ts = tring.ring_init(4, _t(_example()), device="cpu")
    rng = np.random.RandomState(3)
    for _ in range(6):
        item = {k: v[0] for k, v in _items(rng, 1).items()}
        js = jring.ring_add(js, _j(item))
        ts = tring.ring_add(ts, _t(item))
    for k in js.storage:
        np.testing.assert_array_equal(ts.storage[k].numpy(), np.asarray(js.storage[k]))
    assert (ts.ptr, ts.size) == (int(js.ptr), int(js.size)) == (2, 4)
    assert tring.ring_capacity(ts) == jring.ring_capacity(js) == 4
    stored = {k: v.clone() for k, v in ts.storage.items()}
    cleared, jcleared = tring.ring_clear(ts), jring.ring_clear(js)
    assert (cleared.ptr, cleared.size) == (int(jcleared.ptr), int(jcleared.size)) == (0, 0)
    assert all(torch.equal(cleared.storage[k], v) for k, v in stored.items())


def test_per_add_and_capacity_match_jax():
    """``tests/test_buffers.py``'s overfill with single adds (110 into 100), with
    priority updates between the adds so each insert takes a new maximum; the
    empty buffer's first insert gets 1.0."""
    js = jper.per_init(100, _j(_example()))
    ts = tper.per_init(100, _t(_example()), device="cpu")
    rng = np.random.RandomState(4)
    for i in range(110):
        item = {k: v[0] for k, v in _items(rng, 1).items()}
        js = jper.per_add(js, _j(item))
        ts = tper.per_add(ts, _t(item))
        if i % 25 == 24:
            idx = np.sort(rng.choice(min(i + 1, 100), size=5, replace=False))
            err = rng.rand(5).astype(np.float32)
            js = jper.per_update(js, jnp.asarray(idx), jnp.asarray(err))
            ts = tper.per_update(ts, torch.from_numpy(idx), torch.from_numpy(err))
    _assert_same(js, ts)
    assert tper.per_capacity(ts) == jper.per_capacity(js) == 100 and ts.size == 100


def test_seq_capacity_matches_jax():
    from rl6nimmt_tpu.buffers import sequence as jseq
    from rl6nimmt_torch.buffers import sequence as tseq

    example = {"x": np.zeros(3, np.float32)}
    assert tseq.seq_capacity(tseq.seq_init(6, 4, _t(example), device="cpu")) == \
        jseq.seq_capacity(jseq.seq_init(6, 4, _j(example))) == 6
