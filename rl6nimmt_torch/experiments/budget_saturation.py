"""Search-budget saturation: how much strength does each playout buy?

    python -m rl6nimmt_torch.experiments.budget_saturation [--budgets 8,16,32,50,100,200,400]
        [--reference-budget 800] [--games 512] [--seed 0] [--out PATH] [--device cuda]

Port of ``experiments/budget_saturation.py``.  Alpha0.5 (PUCT over net
playouts, K=8, ``mc_per_card`` 10, ``c_puct`` 2.0) with a fresh prior (the
(100, 100) net drawn from ``--seed`` + 1234) at budget N plays the same
searcher at ``--reference-budget``, two seats, ``--games`` games in each seat
order, all in one device block program with per-seat budgets
(``runtime/device_tournament.py`` ``make_device_block_fn``; every seat holds
the same parameter tree, so one search call serves every seat each turn).
Prints, per budget, N's win rate against the reference (ties count half) with
its binomial standard error.  Wherever that rate is about 0.5, a trained
prior has nothing left to add at budget N.

Randomness: one ``torch.Generator`` seeded with ``--seed`` draws every block
in turn, where JAX split a key per block (``PARITY_TORCH.md`` section 19).
Writes the JSON to ``--out`` and returns it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def seat_record(s, seat: int):
    """Wins and ties of ``seat`` against the other seat over the games ``s [G, 2]``."""
    s = np.asarray(s)
    return float(np.sum(s[:, seat] > s[:, 1 - seat])), float(np.sum(s[:, seat] == s[:, 1 - seat]))


def rate_and_se(wins: float, ties: float, n: int):
    """The win rate (ties half) and its binomial standard error."""
    rate = (wins + 0.5 * ties) / n
    return rate, (rate * (1 - rate) / n) ** 0.5


def main(argv=None):
    from ..agents.device_search import KIND_PUCT
    from ..engine import EnvConfig
    from ..nets import MLPSpec, mlp_init
    from ..runtime.device_tournament import make_device_block_fn
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--budgets", default="8,16,32,50,100,200,400")
    parser.add_argument("--reference-budget", type=int, default=800)
    parser.add_argument("--games", type=int, default=512, help="games per seat order")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="rl6nimmt_torch/experiments/results/budget_saturation.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = EnvConfig(num_players=2)
    spec = MLPSpec(input_size=cfg.state_length + 1, hidden_sizes=(100, 100), head_sizes=(1,))
    fresh = mlp_init(torch.Generator().manual_seed(args.seed + 1234), spec, dev)

    G, P = args.games, 2
    block = make_device_block_fn(cfg, spec, G, args.reference_budget, batch=8, device=dev)
    params = [[fresh] * P for _ in range(G)]
    kinds = np.full((G, P), KIND_PUCT, np.int32)
    mc_pers = np.full((G, P), 10, np.int32)
    c_pucts = np.full((G, P), 2.0, np.float32)
    epses = np.zeros((G, P), np.float32)      # no learner seats

    results = {}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for budget in [int(b) for b in args.budgets.split(",")]:
        t0 = time.perf_counter()
        wins = ties = n = 0
        for low_seat in (0, 1):
            budgets = np.full((G, P), args.reference_budget, np.int32)
            budgets[:, low_seat] = budget
            scores, _, _ = block(params, (), kinds, budgets, mc_pers, c_pucts, epses, gen)
            w, t = seat_record(scores.cpu().numpy(), low_seat)
            wins, ties, n = wins + w, ties + t, n + G
        rate, se = rate_and_se(wins, ties, n)
        results[str(budget)] = {"win_rate_vs_saturated": round(rate, 4), "se": round(se, 4), "games": n}
        print(f"mc_max={budget:4d} vs {args.reference_budget}: {rate:.3f} ± {se:.3f} over {n} games "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=2))
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
