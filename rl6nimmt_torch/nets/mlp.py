"""Functional MLPs with factorized noisy linears (port of ``nets/mlp.py``).

Parameters are **plain dicts of leaf tensors**, the same tree as the JAX
pytree: ``{"trunk": [{"w", "b", ("sigma_w", "sigma_b")}, ...], "heads":
[...]}`` with ``w`` laid out ``[in, out]`` so a forward is ``x @ w + b``.
The learner differentiates them with ``torch.autograd.grad`` and a
functional Adam (``agents/dqn.py``); nothing here holds state.

Noise is explicit: :func:`draw_mlp_noise` takes a ``torch.Generator``, and
every apply function takes precomputed noise dicts ``{"eps_in": [in, 1],
"eps_out": [1, out]}`` so tests can inject the JAX package's noise.  Noise
dicts may carry extra leading axes (e.g. one per turn); the effective-weight
math broadcasts over them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..utils.device import resolve_device


@dataclass(frozen=True)
class MLPSpec:
    """Static architecture description (mirrors the JAX ``MLPSpec``)."""

    input_size: int
    hidden_sizes: Tuple[int, ...] = (100, 100)
    head_sizes: Tuple[int, ...] = (1,)
    noisy: bool = False
    sigma_init: float = 0.5
    activation: str = "relu"

    @property
    def layer_sizes(self) -> Tuple[Tuple[int, int], ...]:
        dims = (self.input_size,) + tuple(self.hidden_sizes)
        trunk = tuple(zip(dims[:-1], dims[1:]))
        heads = tuple((dims[-1], h) for h in self.head_sizes)
        return trunk + heads


def _activation(name: str):
    return {"relu": torch.relu, "tanh": torch.tanh,
            "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh")}[name]


# ------------------------------------------------------------------- linears


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int, device="cuda") -> dict:
    """Torch-style default init: U(-1/sqrt(in), 1/sqrt(in)) for w and b.

    Drawn on the generator's device, then moved to ``device``.
    """
    dev = resolve_device(device)
    bound = 1.0 / math.sqrt(in_dim)
    u = lambda *shape: ((torch.rand(shape, generator=generator, device=generator.device) * 2 - 1)
                        * bound).to(dev)
    return {"w": u(in_dim, out_dim), "b": u(out_dim)}


def linear_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def noisy_linear_init(generator, in_dim: int, out_dim: int, sigma_init: float = 0.5,
                      device="cuda") -> dict:
    """Factorized noisy layer: sigma starts at ``sigma_init / sqrt(in)``."""
    params = linear_init(generator, in_dim, out_dim, device)
    sigma0 = sigma_init / math.sqrt(in_dim)
    params["sigma_w"] = torch.full((in_dim, out_dim), sigma0, device=params["w"].device)
    params["sigma_b"] = torch.full((out_dim,), sigma0, device=params["w"].device)
    return params


def _f(v: torch.Tensor) -> torch.Tensor:
    return torch.sign(v) * torch.sqrt(torch.abs(v))


def _factorized_noise(generator: torch.Generator, in_dim: int, out_dim: int,
                      batch: Tuple[int, ...] = ()) -> dict:
    """One factorized noise pair ``f(N(0,1))`` with ``f(v) = sign(v) sqrt|v|``."""
    dev = generator.device
    return {
        "eps_in": _f(torch.randn(batch + (in_dim, 1), generator=generator, device=dev)),
        "eps_out": _f(torch.randn(batch + (1, out_dim), generator=generator, device=dev)),
    }


def noisy_linear_apply(params: dict, x: torch.Tensor, noise: Optional[dict] = None) -> torch.Tensor:
    """Noisy forward; ``noise=None`` runs the mean network."""
    if noise is None:
        return linear_apply(params, x)
    w_eff = params["w"] + params["sigma_w"] * (noise["eps_in"] * noise["eps_out"])
    b_eff = params["b"] + params["sigma_b"] * noise["eps_out"][..., 0, :]
    return x @ w_eff + b_eff


# ----------------------------------------------------------------------- MLP


def mlp_init(generator: torch.Generator, spec: MLPSpec, device="cuda") -> dict:
    """Initialize trunk + head parameters for an :class:`MLPSpec`."""
    if spec.noisy:
        layers = [noisy_linear_init(generator, i, o, spec.sigma_init, device)
                  for i, o in spec.layer_sizes]
    else:
        layers = [linear_init(generator, i, o, device) for i, o in spec.layer_sizes]
    n_trunk = len(spec.hidden_sizes)
    return {"trunk": layers[:n_trunk], "heads": layers[n_trunk:]}


def draw_mlp_noise(spec: MLPSpec, generator: torch.Generator, batch: Tuple[int, ...] = ()) -> list:
    """Per-layer factorized noise; ``batch`` adds leading axes (e.g. ``(T,)``)."""
    return [_factorized_noise(generator, i, o, batch) for i, o in spec.layer_sizes]


def noisy_effective_params(spec: MLPSpec, params: dict, noise: list) -> dict:
    """Collapse a noisy net + drawn noise into plain ``{"w", "b"}`` layers.

    ``w + sigma_w * (eps_in * eps_out)`` and ``b + sigma_b * eps_out``, the
    same elementwise expressions as :func:`noisy_linear_apply`; leading noise
    axes give stacked weights (``[T, in, out]`` for per-turn noise).
    """
    layers = list(params["trunk"]) + list(params["heads"])
    effs = [
        {
            "w": p["w"] + p["sigma_w"] * (z["eps_in"] * z["eps_out"]),
            "b": p["b"] + p["sigma_b"] * z["eps_out"][..., 0, :],
        }
        for p, z in zip(layers, noise)
    ]
    n_trunk = len(params["trunk"])
    return {"trunk": effs[:n_trunk], "heads": effs[n_trunk:]}


def mlp_apply(spec: MLPSpec, params: dict, x: torch.Tensor,
              noise: Optional[list] = None) -> Tuple[torch.Tensor, ...]:
    """Forward pass; returns one output per head.

    For noisy specs ``noise`` (from :func:`draw_mlp_noise`) is applied per
    layer; ``None`` runs the mean network.  ``x`` is ``[..., input_size]``.
    """
    act = _activation(spec.activation)
    n_trunk = len(params["trunk"])
    n_layers = n_trunk + len(params["heads"])
    noises = list(noise) if (spec.noisy and noise is not None) else [None] * n_layers
    apply = noisy_linear_apply if spec.noisy else (lambda p, v, nz: linear_apply(p, v))
    h = x
    for p, nz in zip(params["trunk"], noises):
        h = act(apply(p, h, nz))
    return tuple(apply(p, h, nz) for p, nz in zip(params["heads"], noises[n_trunk:]))


def dueling_apply(spec: MLPSpec, params: dict, x: torch.Tensor,
                  noise: Optional[list] = None) -> torch.Tensor:
    """Dueling aggregation ``Q = V + (A - mean(A))``; heads must be ``(1, A)``."""
    v, a = mlp_apply(spec, params, x, noise)
    return v + (a - a.mean(dim=-1, keepdim=True))
