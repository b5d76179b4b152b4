"""Strength A/B of PUCT's round width K on the device search path.

    python -m rl6nimmt_torch.experiments.puct_batch_ab [--games 256] [--keys 4] [--ks 8,16,32]
        [--mc-max 200] [--out PATH] [--device cuda]

Port of ``experiments/puct_batch_ab.py``.  A device decision runs its
playouts in ``ceil(mc_max / K)`` sequential rounds, and PUCT re-selects
first moves from the outcome statistics between rounds: a larger K cuts the
sequential depth but refreshes the root's statistics less often.  Seat 0 is
Alpha0.5 (a fixed fresh prior, the same in every arm) against (MCS, MCS,
random), four seats, ``make_device_match_fn(cfg, roster, spec, games, mc_max,
10, K, 2.0)``.  Every arm plays match ``e`` from a ``torch.Generator`` seeded
``1000 + e``, whose first draw is the K2 deal's seed: all arms are dealt the
same games, so the per-game deltas of seat 0's score against the first K's
are paired (``PARITY_TORCH.md`` section 19).  Prints seat 0's mean score, its
win rate and the warm seconds a call per K, and each K's paired delta with
its 95% interval.  Writes the JSON to ``--out`` and returns it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

ROSTER = ("puct", "uniform", "uniform", "random")


def paired_delta(scores_k, scores_base) -> dict:
    """Mean per-game delta of seat 0's score and its 95% half-width, over ``[keys, G]``."""
    d = (np.asarray(scores_k) - np.asarray(scores_base)).ravel()
    n = d.size
    return {"mean": float(d.mean()), "ci95": float(1.96 * d.std(ddof=1) / np.sqrt(n)), "n": int(n)}


def main(argv=None):
    from ..engine import EnvConfig
    from ..nets import MLPSpec, mlp_init
    from ..runtime.device_match import make_device_match_fn
    from ..utils.device import resolve_device, synchronize

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--games", type=int, default=256)
    parser.add_argument("--keys", type=int, default=4)
    parser.add_argument("--ks", type=str, default="8,16,32")
    parser.add_argument("--mc-max", type=int, default=200)
    parser.add_argument("--out", type=str, default="rl6nimmt_torch/experiments/results/puct_batch_ab.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    ks = [int(k) for k in args.ks.split(",")]

    cfg = EnvConfig(num_players=4)
    spec = MLPSpec(input_size=cfg.state_length + 1, hidden_sizes=(100, 100), head_sizes=(1,))
    prior = mlp_init(torch.Generator().manual_seed(7), spec, dev)     # the same fresh prior in every arm
    params = (prior, None, None, None)

    result = {"config": vars(args), "arms": {}}
    scores = {}     # K -> [keys, G] seat-0 scores
    for k in ks:
        fn = make_device_match_fn(cfg, ROSTER, spec, args.games, args.mc_max, 10, k, 2.0, device=dev)
        per_key, wall = [], []
        for e in range(args.keys):
            gen = torch.Generator(device=dev).manual_seed(1000 + e)   # shared across arms: paired deals
            synchronize(dev)
            t0 = time.perf_counter()
            s = fn(params, gen).cpu().numpy()
            wall.append(time.perf_counter() - t0)
            per_key.append(s)
        s = np.stack(per_key)   # [keys, G, P]
        scores[k] = s[:, :, 0]
        wins = (s[:, :, 0] == s.max(axis=2)).mean()
        result["arms"][str(k)] = {"mean_score": float(s[:, :, 0].mean()), "win_rate": float(wins),
                                  "warm_s_per_call": float(min(wall[1:]) if len(wall) > 1 else wall[0])}
        print(f"K={k:3d} mean={s[:, :, 0].mean():7.3f} win={wins:.3f} "
              f"warm={min(wall[1:] or wall):.2f}s/{args.games}g", flush=True)

    base = ks[0]
    for k in ks[1:]:
        delta = paired_delta(scores[k], scores[base])
        result["arms"][str(k)]["paired_delta_vs_base"] = delta
        print(f"K={k} - K={base}: delta={delta['mean']:+.3f} ± {delta['ci95']:.3f} (CI95, n={delta['n']})")

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print("wrote", args.out)
    return result


if __name__ == "__main__":
    main()
