"""Port nets vs JAX nets on converted weights and shared noise (allclose)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl6nimmt_tpu import nets as jnets
from rl6nimmt_torch import nets as tnets

RTOL, ATOL = 1e-5, 1e-6


def assert_f32_close(actual, desired):
    """rtol 1e-5, atol 1e-6 scaled by the tensor's largest magnitude.

    XLA and torch sum the 47-term (and 64-term) dot products in different
    orders.  The rounding of a reassociated f32 sum scales with the size of
    its terms (card ids up to 103), not with the result, so an output that
    cancels to near zero carries the absolute error of its large neighbours.
    """
    desired = np.asarray(desired)
    scale = max(1.0, float(np.abs(desired).max()))
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=RTOL, atol=ATOL * scale)


def _spec_pair(noisy, heads=(1, 104), hidden=(64,)):
    j = jnets.MLPSpec(input_size=47, hidden_sizes=hidden, head_sizes=heads, noisy=noisy)
    t = tnets.MLPSpec(input_size=47, hidden_sizes=hidden, head_sizes=heads, noisy=noisy)
    return j, t


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(n=16):
    rng = np.random.RandomState(5)
    return rng.randint(-1, 104, size=(n, 4, 47)).astype(np.float32)


@pytest.mark.parametrize("hidden", [(64,), (32, 16)])
def test_mlp_and_dueling_forward(hidden):
    jspec, tspec = _spec_pair(False, hidden=hidden)
    jp = jnets.mlp_init(jax.random.key(0), jspec)
    tp = tnets.params_from_jax(_to_np(jp), "cpu")
    x = _inputs()
    for jo, to in zip(jnets.mlp_apply(jspec, jp, x), tnets.mlp_apply(tspec, tp, torch.as_tensor(x))):
        assert_f32_close(to.numpy(), jo)
    assert_f32_close(tnets.dueling_apply(tspec, tp, torch.as_tensor(x)).numpy(),
                     jnets.dueling_apply(jspec, jp, x))


def test_noisy_forward_with_injected_noise():
    jspec, tspec = _spec_pair(True)
    jp = jnets.mlp_init(jax.random.key(1), jspec)
    tp = tnets.params_from_jax(_to_np(jp), "cpu")
    noise = jnets.draw_mlp_noise(jspec, jax.random.key(2))
    tnoise = tnets.noise_from_jax(_to_np(noise), "cpu")
    x = _inputs()
    assert_f32_close(tnets.dueling_apply(tspec, tp, torch.as_tensor(x), tnoise).numpy(),
                     jnets.dueling_apply(jspec, jp, x, noise=noise))
    # Mean network (no noise).
    assert_f32_close(tnets.mlp_apply(tspec, tp, torch.as_tensor(x))[1].numpy(),
                     jnets.mlp_apply(jspec, jp, x)[1])


def test_noisy_effective_params_per_turn():
    """Stacked per-turn noise -> stacked effective weights, and the plain
    forward on them equals the noisy forward."""
    jspec, tspec = _spec_pair(True)
    jp = jnets.mlp_init(jax.random.key(3), jspec)
    tp = tnets.params_from_jax(_to_np(jp), "cpu")
    keys = jax.random.split(jax.random.key(4), 10)
    jnoise = jax.vmap(lambda k: jnets.draw_mlp_noise(jspec, k))(keys)
    jeff = jax.vmap(lambda nz: jnets.noisy_effective_params(jspec, jp, nz))(jnoise)
    teff = tnets.noisy_effective_params(tspec, tp, tnets.noise_from_jax(_to_np(jnoise), "cpu"))
    for part in ("trunk", "heads"):
        for jl, tl in zip(jeff[part], teff[part]):
            for k in ("w", "b"):
                assert_f32_close(tl[k].numpy(), jl[k])
    x = torch.as_tensor(_inputs())
    plain = dataclasses.replace(tspec, noisy=False)
    turn3 = {p: [{k: v[3] for k, v in l.items()} for l in teff[p]] for p in ("trunk", "heads")}
    noise3 = [{k: v[3] for k, v in l.items()} for l in tnets.noise_from_jax(_to_np(jnoise), "cpu")]
    assert_f32_close(tnets.dueling_apply(plain, turn3, x).numpy(),
                     tnets.dueling_apply(tspec, tp, x, noise3).numpy())


def test_params_round_trip_and_init_shapes():
    jspec, tspec = _spec_pair(True)
    jp = _to_np(jnets.mlp_init(jax.random.key(5), jspec))
    back = tnets.params_to_numpy(tnets.params_from_jax(jp, "cpu"))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    tp = tnets.mlp_init(torch.Generator().manual_seed(0), tspec, device="cpu")
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tnets.params_to_numpy(tp))):
        assert a.shape == b.shape and b.dtype == np.float32
    # Factorized sigma starts at sigma_init / sqrt(in) and U(+-1/sqrt(in)) weights.
    assert np.allclose(tp["trunk"][0]["sigma_w"].numpy(), 0.5 / np.sqrt(47))
    assert float(tp["trunk"][0]["w"].abs().max()) <= 1 / np.sqrt(47)
