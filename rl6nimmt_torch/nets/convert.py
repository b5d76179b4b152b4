"""Carry weights between the JAX pytree and the port's parameter dicts.

Both use the same tree, ``{"trunk": [{"w", "b", "sigma_w", "sigma_b"}],
"heads": [...]}`` with ``w [in, out]``, so conversion is a leaf-wise copy.
The JAX side is handed over as numpy arrays (``jax.tree.map(np.asarray,
params)``), so this module needs no JAX.
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
