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

``MLPSpec.compute_dtype="bfloat16"`` rounds both inputs of every product to
bfloat16 and keeps a float32 result (:func:`_mm`, JAX's
``preferred_element_type=float32``); parameters, biases and activations stay
float32.  The default ``"float32"`` runs the plain ``x @ w``.
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
    # The products' input dtype: "bfloat16" rounds both operands and keeps a
    # float32 result (mixed precision; the parameters stay float32).
    compute_dtype: str = "float32"

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


def _mm(x: torch.Tensor, w: torch.Tensor, dtype: Optional[str] = None) -> torch.Tensor:
    """``x @ w``, or with ``dtype="bfloat16"`` the product of the operands rounded
    to bfloat16 with a float32 result (port of JAX's ``_mm``).

    The rounded operands are widened and multiplied in float32: the product of
    two bfloat16 values is exact in float32 (and in TF32), so this gives JAX's
    values up to the float32 summation order on every device, and its autograd
    (the casts' transposes) rounds each operand's gradient to bfloat16 as
    JAX's transpose does.  The tensor cores' ``torch.mm(..., out_dtype=float32)``
    is not used: a REINFORCE forward through it once missed these values on the
    card by 1.14e-3 of the output's scale (``PARITY_TORCH.md`` section 20)."""
    if dtype is None or dtype == "float32":
        return x @ w
    if dtype != "bfloat16":
        raise ValueError(f"compute_dtype {dtype!r}: float32 or bfloat16")
    return x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.bfloat16).to(torch.float32)


def linear_apply(params: dict, x: torch.Tensor, dtype: Optional[str] = None) -> torch.Tensor:
    return _mm(x, params["w"], dtype) + params["b"]


def noisy_linear_init(generator, in_dim: int, out_dim: int, sigma_init: float = 0.5,
                      device="cuda", factorized: bool = True) -> dict:
    """Noisy layer parameters.

    The factorized layer's sigma starts at ``sigma_init / sqrt(in)``
    (reference nets.py:42-49); the independent layer's is ``sigma_init``
    itself, and its weights are drawn again, uniform with bound
    ``sqrt(3 / in)`` (nets.py:13-25).
    """
    params = linear_init(generator, in_dim, out_dim, device)
    if factorized:
        sigma0 = sigma_init / math.sqrt(in_dim)
    else:
        sigma0 = sigma_init
        bound = math.sqrt(3.0 / in_dim)
        dev = params["w"].device
        u = lambda *shape: ((torch.rand(shape, generator=generator, device=generator.device) * 2 - 1)
                            * bound).to(dev)
        params["w"], params["b"] = u(in_dim, out_dim), u(out_dim)
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


def noisy_linear_apply(params: dict, x: torch.Tensor, noise: Optional[dict] = None,
                       factorized: bool = True, dtype: Optional[str] = None) -> torch.Tensor:
    """Noisy forward; ``noise=None`` runs the mean network.

    ``noise`` is a factorized pair (:func:`_factorized_noise`), or with
    ``factorized=False`` an independent standard-normal draw ``{"w" [in, out],
    "b" [out]}``: ``w + sigma_w * w_noise``, ``b + sigma_b * b_noise``.
    """
    if noise is None:
        return linear_apply(params, x, dtype)
    if not factorized:
        return (_mm(x, params["w"] + params["sigma_w"] * noise["w"], dtype)
                + (params["b"] + params["sigma_b"] * noise["b"]))
    w_eff = params["w"] + params["sigma_w"] * (noise["eps_in"] * noise["eps_out"])
    b_eff = params["b"] + params["sigma_b"] * noise["eps_out"][..., 0, :]
    return _mm(x, w_eff, dtype) + b_eff


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
    dtype = spec.compute_dtype
    apply = ((lambda p, v, nz: noisy_linear_apply(p, v, nz, dtype=dtype)) if spec.noisy
             else (lambda p, v, nz: linear_apply(p, v, dtype)))
    h = x
    for p, nz in zip(params["trunk"], noises):
        h = act(apply(p, h, nz))
    return tuple(apply(p, h, nz) for p, nz in zip(params["heads"], noises[n_trunk:]))


def dueling_apply(spec: MLPSpec, params: dict, x: torch.Tensor,
                  noise: Optional[list] = None) -> torch.Tensor:
    """Dueling aggregation ``Q = V + (A - mean(A))``; heads must be ``(1, A)``."""
    v, a = mlp_apply(spec, params, x, noise)
    return v + (a - a.mean(dim=-1, keepdim=True))
