"""Carry weights between the JAX pytree and the port's parameter dicts.

Both use the same tree, ``{"trunk": [{"w", "b", "sigma_w", "sigma_b"}],
"heads": [...]}`` with ``w [in, out]``, so conversion is a leaf-wise copy.
The JAX side is handed over as numpy arrays (``jax.tree.map(np.asarray,
params)``), so this module needs no JAX.  An ``optax.adam`` state converts to
the port's :class:`~..agents.dqn.AdamState` (its step count and both moments).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


def params_from_jax(tree, device="cuda", dtype=torch.float32) -> dict:
    """Port params from a JAX parameter tree given as numpy arrays."""
    dev = resolve_device(device)

    def conv(layer):
        return {k: torch.tensor(np.asarray(v), dtype=dtype, device=dev) for k, v in layer.items()}

    return {"trunk": [conv(l) for l in tree["trunk"]], "heads": [conv(l) for l in tree["heads"]]}


def params_to_numpy(params) -> dict:
    """Inverse of :func:`params_from_jax`: the tree with numpy leaves."""
    def conv(layer):
        return {k: v.detach().cpu().numpy() for k, v in layer.items()}

    return {"trunk": [conv(l) for l in params["trunk"]], "heads": [conv(l) for l in params["heads"]]}


def noise_from_jax(noise, device="cuda") -> list:
    """Per-layer noise dicts (``draw_mlp_noise`` output) from numpy arrays."""
    dev = resolve_device(device)
    return [{k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
             for k, v in layer.items()} for layer in noise]


def adam_state_from_jax(state, device="cuda"):
    """The port's ``AdamState`` from an ``optax.adam`` state given as numpy
    arrays: the element of the chain's state tuple that holds ``count``,
    ``mu`` and ``nu`` (``ScaleByAdamState``)."""
    from ..agents.dqn import AdamState

    elems = (state,) if hasattr(state, "mu") else state
    (adam,) = [e for e in elems if hasattr(e, "mu") and hasattr(e, "nu")]
    return AdamState(int(np.asarray(adam.count)), params_from_jax(adam.mu, device), params_from_jax(adam.nu, device))
