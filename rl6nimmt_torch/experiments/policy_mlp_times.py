"""Device times of the action-in-input policy forward (``ops/policy_mlp.py``) at the benchmark cells' shapes.

    python -m rl6nimmt_torch.experiments.policy_mlp_times [--reps 5]

Per shape it prints one JSON line with the kernel's milliseconds a launch
(CUDA events around back-to-back launches, the median of ``--reps`` runs),
the same with the hidden tensors kept (the training path's forward), the plain
twin's (the same ops as the plain route of ``action_in_input_logits``), and
the least time the card could take: the live rows' FLOPs (``2 D^2 + 7 D`` a
row) at 67 TFLOP/s against the bytes (the state products, the cards,
the logits and, when kept, ``h1`` and ``h2``) at 3.35 TB/s.  The shapes are a
train step's ten turns (262,144 seats, ``S = 10 - t`` live slots) and a
REINFORCE evaluation match's (131,072 games, 10 slots, ``10 - t`` of them
live); a last line sums each over its ten turns.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..nets import MLPSpec, mlp_init
from ..ops import _build
from ..ops.policy_mlp import _launch, policy_mlp_plain
from .kernel_times import cuda_ms

F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
D = 100
TRAIN_SEATS, EVAL_GAMES, HAND = 262_144, 131_072, 10


def inputs(M: int, S: int, live: int, dev, seed: int = 0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = mlp_init(gen, MLPSpec(48, hidden_sizes=(D, D)), dev)
    w1, b1 = params["trunk"][0]["w"], params["trunk"][0]["b"]
    shared = (torch.rand((M, 47), generator=gen, device=dev) * 2 - 1) @ w1[1:] + b1
    cards = torch.randint(0, 104, (M, S), generator=gen, device=dev, dtype=torch.int32)
    cards[:, live:] = -1
    return shared, cards, (w1[0], params["trunk"][1]["w"], params["trunk"][1]["b"], params["heads"][0]["w"],
                           params["heads"][0]["b"])


def bound_ms(M: int, S: int, live: int, save: bool) -> float:
    flops = M * live * (2 * D * D + 3 * D + 4 * D)
    nbytes = 4 * (M * D + 2 * M * S) + (8 * M * S * D if save else 0)
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES) * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("policy_mlp_times needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    _build.library()
    shapes = ([("train", TRAIN_SEATS, HAND - t, HAND - t, True) for t in range(HAND)]
              + [("eval", EVAL_GAMES, HAND, HAND - t, False) for t in range(HAND)])
    rows, totals = [], {}
    for cell, M, S, live, save in shapes:
        shared, cards, w = inputs(M, S, live, dev)
        row = {"cell": cell, "M": M, "S": S, "live": live,
               "kernel_ms": cuda_ms(lambda: _launch(shared, cards, *w, 103.0, False), args.iters, args.reps),
               "bound_ms": bound_ms(M, S, live, False)}
        if save:
            row["kernel_kept_ms"] = cuda_ms(lambda: _launch(shared, cards, *w, 103.0, True), args.iters, args.reps)
            row["bound_kept_ms"] = bound_ms(M, S, live, True)
        with torch.no_grad():
            row["twin_ms"] = cuda_ms(lambda: policy_mlp_plain(shared, cards, *w, 103.0), args.iters, args.reps)
        row["kernel_tflops"] = M * live * 2 * D * D / row["kernel_ms"] / 1e9
        for k, v in row.items():
            if k.endswith("_ms"):
                totals.setdefault(cell, {}).setdefault(k, 0.0)
                totals[cell][k] += v
        print(json.dumps({**row, "card": card}), flush=True)
        rows.append(row)
    print(json.dumps({"totals_over_ten_turns": totals, "card": card}), flush=True)
    return {"rows": rows, "totals": totals, "card": card}


if __name__ == "__main__":
    main()
