"""The search path on the card against the same path on the CPU.

:func:`card_against_cpu` runs one block of kind-static decisions twice on
the same noise -- drawn on the CPU, copied to the card -- once on the card
(every playout turn one K1 launch) and once with ``device="cpu"`` (the plain
resolver), and returns both sides' chosen actions, per-action outcome sums
and playout counts, which must be equal.  ``chip_smoke.py`` and the GPU tests
use it.

The positions are real openings (:func:`search_position`: K2 deals, seat 0
searches).  A PUCT root takes its prior from the net; a random net's float32
logits differ between cuBLAS and the CPU in their last bits, which could flip
a PUCT pick at a near-tie.  So the check's net (:func:`exact_prior`) computes
the same logits on both devices, bit for bit, and gives every card its own:
its log-softmax may still differ by a rounding between the devices, which
moves no pick unless two PUCT scores tie to that rounding.  A uniform prior
makes such ties by construction: with p = 1/n and c_puct = 2 the exploration
term c p sqrt(N) / (1 + n) meets the differences of the normalized outcomes
exactly (at N = 1, 2 p / 2 = 0.1 apart for n = 10), and on the CPU a 1-ulp
change of a uniform prior moved picks in every block tried.
"""

from __future__ import annotations

import math

import torch

from ..agents.device_search import _best, _make_search, _Noise, _static_roots, draw_decision_noise
from ..engine import EnvConfig, deal, observe
from ..nets import MLPSpec
from ..utils.device import resolve_device
from .device_match import board_seen


def search_position(cfg: EnvConfig, seed: int, num_games: int, device="cuda") -> tuple:
    """Seat 0's view of ``num_games`` fresh deals of ``seed`` (K2 on the card):
    ``(board, row_len, my_hand, avail, obs)``, the card memory being every
    card neither on the board nor in seat 0's hand."""
    state = deal(cfg, seed, num_games, device=resolve_device(device))
    obs, _ = observe(cfg, state)
    avail = ~(board_seen(cfg, state) | state.hands[:, 0])
    return state.board, state.row_len, state.hands_sorted[:, 0].contiguous(), avail, obs[:, 0].contiguous()


def exact_prior(spec: MLPSpec, device="cuda") -> dict:
    """A net of ``spec`` (ReLU, first head) whose logit for card ``c`` is
    ``1.5 + norm(c)``, passed through unit 0 of every layer: one nonzero weight
    per layer (1.0), so every product is exact and every sum adds zeros, and
    any device computes the same logits bit for bit (with TF32 off)."""
    dev = resolve_device(device)
    layers = [{"w": torch.zeros((i, o)), "b": torch.zeros(o)} for i, o in spec.layer_sizes]
    for layer in layers:
        layer["w"][0, 0] = 1.0
    layers[0]["b"][0] = 1.5
    layers = [{k: v.to(dev) for k, v in layer.items()} for layer in layers]
    n_trunk = len(spec.hidden_sizes)
    return {"trunk": layers[:n_trunk], "heads": layers[n_trunk:]}


def card_against_cpu(cfg: EnvConfig, spec: MLPSpec, root: str, num_games: int, K: int, mc_max: int,
                     seed: int) -> dict:
    """One block of ``root`` decisions on uniform playouts at the opening
    (``n = hand_size``, ``n_mc = mc_max``), on the card and on the CPU with one
    noise.  Returns ``{"card": (actions, act_sum, act_cnt), "cpu": (...),
    "equal": bool}``, every tensor on the CPU; ``equal`` also needs the two
    positions equal.  Needs full float32 matmuls on the card
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("card_against_cpu needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    n, k = cfg.hand_size, min(K, mc_max)
    gen = torch.Generator().manual_seed(seed)
    noise = draw_decision_noise(gen, cfg, num_games, k, n, math.ceil(mc_max / k), first=root != "puct")
    roots = _static_roots(root, "uniform", num_games)
    out, positions = {}, {}
    for where in ("cuda", "cpu"):
        dev = resolve_device(where)
        board, row_len, hand, avail, obs = positions[where] = search_position(cfg, seed, num_games, dev)
        # The decision's round loop, called once: its statistics and its choice.
        search = _make_search(cfg, spec, mc_max, K, dev)
        act_sum, act_cnt, _, _ = search(exact_prior(spec, dev), roots, board, row_len, hand, n, mc_max, 2.0, avail,
                                        obs, _Noise(noise, dev))
        actions = torch.gather(hand, 1, _best(act_sum, act_cnt)[:, None])[:, 0]
        out[where] = tuple(x.cpu() for x in (actions, act_sum, act_cnt))
    out["card"] = out.pop("cuda")
    same_position = all(torch.equal(a.cpu(), b) for a, b in zip(positions["cuda"], positions["cpu"]))
    out["equal"] = same_position and all(torch.equal(a, b) for a, b in zip(out["card"], out["cpu"]))
    return out
