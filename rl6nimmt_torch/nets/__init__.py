"""Functional nets (port of ``rl6nimmt_tpu.nets``)."""

from .convert import adam_state_from_jax, noise_from_jax, params_from_jax, params_to_numpy
from .mlp import (
    MLPSpec,
    draw_mlp_noise,
    dueling_apply,
    linear_apply,
    linear_init,
    mlp_apply,
    mlp_init,
    noisy_effective_params,
    noisy_linear_apply,
    noisy_linear_init,
)
from .normalize import normalize_state

__all__ = [
    "MLPSpec",
    "adam_state_from_jax",
    "draw_mlp_noise",
    "dueling_apply",
    "linear_apply",
    "linear_init",
    "mlp_apply",
    "mlp_init",
    "noise_from_jax",
    "noisy_effective_params",
    "noisy_linear_apply",
    "noisy_linear_init",
    "normalize_state",
    "params_from_jax",
    "params_to_numpy",
]
