"""Plain reference forwards of the configurations' nets, and their weights drawn from a seed.

A net is a configuration's ``net`` block: ``input_size``, ``hidden_sizes``,
``head_sizes`` and, for a noisy net, ``sigma_init``.  Weights are a tree
``{"trunk": [layer, ...], "heads": [layer, ...]}`` of layers ``{"w" [in, out],
"b" [out]}`` (a noisy layer adds ``sigma_w`` and ``sigma_b``): the layout the
program takes, filled by the benchmark, never by the program.

* ``w`` and ``b`` are uniform in ``(-1/sqrt(in), 1/sqrt(in))``, a noisy
  layer's sigmas ``sigma_init / sqrt(in)`` (factorized noisy nets, Fortunato
  et al. 2018); all drawn in one call on the device.
* :func:`policy_logits`: the action-in-input policy, one row ``[card |
  observation]`` a candidate card, normalized block by block to ``[-1, 1]``,
  through the MLP to one logit; ``-1`` candidates get ``NEG_INF``.
* :func:`dueling_q`: the noisy dueling Q net on the raw observation, with one
  factorized noise pair a layer, ``w + sigma_w * (eps_in eps_out)`` and ``b +
  sigma_b * eps_out`` (the pair is drawn as ``f(N(0, 1))``, ``f(x) = sign(x)
  sqrt(|x|)``, by the traffic): ``Q = V + A - mean(A)``.
"""

from __future__ import annotations

import math

import torch

from ..common import NEG_INF


def layer_sizes(net: dict):
    dims = [int(net["input_size"])] + [int(h) for h in net["hidden_sizes"]]
    return list(zip(dims[:-1], dims[1:])) + [(dims[-1], int(h)) for h in net["head_sizes"]]


def make_weights(net: dict, seed: int, device) -> dict:
    """The net's weights from ``seed``, drawn on ``device`` in one call."""
    sizes = layer_sizes(net)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(i * o + o for i, o in sizes), generator=gen, device=device) * 2 - 1
    layers, at = [], 0
    for i, o in sizes:
        bound = 1.0 / math.sqrt(i)
        layer = {"w": u[at: at + i * o].view(i, o) * bound, "b": u[at + i * o: at + i * o + o] * bound}
        at += i * o + o
        if net.get("noisy"):
            sigma = float(net["sigma_init"]) / math.sqrt(i)
            layer["sigma_w"] = torch.full((i, o), sigma, device=device)
            layer["sigma_b"] = torch.full((o,), sigma, device=device)
        layers.append(layer)
    n = len(net["hidden_sizes"])
    return {"trunk": layers[:n], "heads": layers[n:]}


def _segments(rules, action: bool):
    """``(lo, hi)`` of each feature: the published normalization ranges."""
    C, H, R = rules.num_cards, rules.hand_size, rules.num_rows
    blocks = ([(1, 0, C - 1)] if action else []) + [(H, 0, C - 1), (1, 0, 6), (R, 1, 5), (R, 0, C - 1), (R, 1, 10)]
    n = rules.obs_size + int(action) - sum(b[0] for b in blocks)
    blocks.append((n, 0, C - 1))
    lo = torch.tensor([b[1] for b in blocks for _ in range(b[0])], dtype=torch.float32)
    hi = torch.tensor([b[2] for b in blocks for _ in range(b[0])], dtype=torch.float32)
    return lo, hi


def normalize(rules, x: torch.Tensor, action: bool) -> torch.Tensor:
    lo, hi = (t.to(x.device) for t in _segments(rules, action))
    return -1.0 + 2.0 * (x - lo) / (hi - lo)


def mlp(params: dict, x: torch.Tensor, noise=None):
    """Every head's output of the ReLU MLP; ``noise``: one ``{"eps_in" [in, 1],
    "eps_out" [1, out]}`` a layer."""
    layers = params["trunk"] + params["heads"]
    def apply(k, layer, v):
        w, b = layer["w"], layer["b"]
        if noise is not None:
            e_in, e_out = noise[k]["eps_in"], noise[k]["eps_out"]
            w = w + layer["sigma_w"] * (e_in * e_out)
            b = b + layer["sigma_b"] * e_out[0]
        return v @ w + b
    h = x
    n = len(params["trunk"])
    for k in range(n):
        h = torch.relu(apply(k, layers[k], h))
    return [apply(n + k, layer, h) for k, layer in enumerate(params["heads"])]


def policy_logits(rules, params: dict, obs: torch.Tensor, cards: torch.Tensor) -> torch.Tensor:
    """``f32[..., K]``: the logit of each candidate card of ``cards [..., K]`` (``-1``: none)."""
    rows = torch.cat([cards.to(torch.float32)[..., None],
                      obs[..., None, :].expand(*cards.shape, obs.shape[-1])], dim=-1)
    (logit,) = mlp(params, normalize(rules, rows, action=True))
    return torch.where(cards >= 0, logit[..., 0], NEG_INF)


def dueling_q(params: dict, obs: torch.Tensor, noise) -> torch.Tensor:
    """``f32[..., A]``: Q of every action on the raw observation under ``noise``."""
    v, a = mlp(params, obs, noise)
    return v + (a - a.mean(dim=-1, keepdim=True))
