"""Functional convolutional stack (port of ``nets/cnn.py``).

The reference ships a WIP conv net that no agent uses (nets.py:66-97); this
is its functional equivalent -- conv blocks of (conv -> activation -> 2x2 max
pool) -- kept for inventory parity.  Inputs and outputs are NHWC and the
weights HWIO, the JAX package's layouts, so its parameters carry over leaf
for leaf (:func:`cnn_params_from_jax`); the forward permutes to PyTorch's
NCHW / OIHW around ``conv2d``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .mlp import _activation


@dataclass(frozen=True)
class CNNSpec:
    in_channels: int
    hidden_channels: Tuple[int, ...]
    out_channels: int
    kernel_size: int = 3
    stride: int = 1
    padding: int = 1
    activation: str = "relu"

    @property
    def channel_sizes(self) -> Tuple[int, ...]:
        return (self.in_channels,) + tuple(self.hidden_channels) + (self.out_channels,)

    def linear_out_size(self, h: int, w: int) -> int:
        """Flattened feature size after all blocks (reference nets.py:88-94).
        The reference counts one pool too many (``len(sizes)`` blocks where
        the stack has ``len(sizes) - 1``); kept as-is for parity."""
        blocks = len(self.channel_sizes)
        return int(h * 0.5**blocks) * int(w * 0.5**blocks) * self.out_channels


def cnn_init(generator: torch.Generator, spec: CNNSpec, device="cuda") -> list:
    """Per block ``{"w" f32[k, k, c_in, c_out], "b" f32[c_out]}``, uniform with
    bound ``1 / sqrt(c_in * k * k)``."""
    dev = resolve_device(device)
    k, layers = spec.kernel_size, []
    for c_in, c_out in zip(spec.channel_sizes[:-1], spec.channel_sizes[1:]):
        bound = 1.0 / math.sqrt(c_in * k * k)
        u = lambda *shape: ((torch.rand(shape, generator=generator, device=generator.device) * 2 - 1)
                            * bound).to(dev)
        layers.append({"w": u(k, k, c_in, c_out), "b": u(c_out)})
    return layers


def cnn_apply(spec: CNNSpec, params: list, x: torch.Tensor) -> torch.Tensor:
    """Forward pass over NHWC inputs ``[B, H, W, C_in]``; NHWC out."""
    act = _activation(spec.activation)
    h = x.permute(0, 3, 1, 2)
    for layer in params:
        h = F.conv2d(h, layer["w"].permute(3, 2, 0, 1), stride=spec.stride, padding=spec.padding)
        h = act(h + layer["b"][:, None, None])
        h = F.max_pool2d(h, 2, 2)
    return h.permute(0, 2, 3, 1)


def cnn_params_from_jax(layers, device="cuda") -> list:
    """Port CNN params from the JAX package's list of ``{"w", "b"}`` (numpy arrays)."""
    dev = resolve_device(device)
    return [{k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev) for k, v in layer.items()}
            for layer in layers]
