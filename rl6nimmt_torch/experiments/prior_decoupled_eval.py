"""Decoupled-prior evaluation: does the trained Alpha0.5 prior help when it only steers the root?

    python -m rl6nimmt_torch.experiments.prior_decoupled_eval [--params PATH] [--games 512]
        [--budgets 50,100] [--matchups A,B,C,D] [--seed 0] [--out PATH] [--device cuda]

Port of ``experiments/prior_decoupled_eval.py``.  One net is both the PUCT
root prior and the playout policy of every seat of every determinized
rollout; the ``puct_uniform`` kind takes the root prior from the net and
plays uniform playouts, which separates the two roles.  Matchups, each two
two-seat device matches (``runtime/device_match.py``
``make_device_match_fn``) with the seats alternated, at every budget:

  A. puct(trained)          vs puct(fresh)            -- the control
  B. puct_uniform(trained)  vs puct_uniform(fresh)    -- the root role's value of training
  C. puct_uniform(trained)  vs puct(fresh)            -- decoupled-trained against standard
  D. puct_uniform(fresh)    vs puct(fresh)            -- decoupling alone, no training

The trained prior is the committed ``experiments/results/puct_prior2p_params.npz``
(the JAX package's 64k-game self-imitation run: 48 -> 100 -> 100 -> 1; the
default path is relative to the repository's root), loaded through
``utils.load_params``, which reads either package's npz; the
fresh one is drawn from ``--seed`` + 1234.  Prints side A's win rate (ties
half) with its binomial standard error per matchup and budget.  One
``torch.Generator`` seeded with ``--seed`` draws every match in turn, where
JAX split a key per matchup (``PARITY_TORCH.md`` section 19).  Writes the
JSON to ``--out`` when given, and returns it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from . import arena_eval

DEFAULT_PARAMS = "experiments/results/puct_prior2p_params.npz"


def head_to_head(match_ab, match_ba, params_a, params_b, generator):
    """Alternating-seat win rate of side A (0.5 per tie)."""
    s_a = match_ab((params_a, params_b), generator).cpu().numpy()   # A in seat 0
    s_b = match_ba((params_b, params_a), generator).cpu().numpy()   # A in seat 1
    return arena_eval.alternating_record(s_a, s_b)


def main(argv=None):
    from ..engine import EnvConfig
    from ..nets import MLPSpec, mlp_init
    from ..runtime.device_match import make_device_match_fn
    from ..utils import load_params
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--params", default=DEFAULT_PARAMS,
                        help="trained prior (the JAX package's 64k-game self-imitation npz)")
    parser.add_argument("--games", type=int, default=512, help="games per seat order")
    parser.add_argument("--budgets", default="50,100")
    parser.add_argument("--matchups", default="A,B,C,D")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = EnvConfig(num_players=2)
    spec = MLPSpec(input_size=cfg.state_length + 1, hidden_sizes=(100, 100), head_sizes=(1,))
    fresh = mlp_init(torch.Generator().manual_seed(args.seed + 1234), spec, dev)
    trained = load_params(args.params, fresh)

    matchups = {
        "A": ("puct", trained, "puct", fresh),
        "B": ("puct_uniform", trained, "puct_uniform", fresh),
        "C": ("puct_uniform", trained, "puct", fresh),
        "D": ("puct_uniform", fresh, "puct", fresh),
    }

    results = {}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for mc_max in [int(b) for b in args.budgets.split(",")]:
        for tag in args.matchups.split(","):
            kind_a, pa, kind_b, pb = matchups[tag]
            t0 = time.perf_counter()
            match_ab = make_device_match_fn(cfg, (kind_a, kind_b), spec, args.games, mc_max=mc_max, device=dev)
            match_ba = make_device_match_fn(cfg, (kind_b, kind_a), spec, args.games, mc_max=mc_max, device=dev)
            rate, se, n = head_to_head(match_ab, match_ba, pa, pb, gen)
            results[f"{tag}@{mc_max}"] = {"matchup": f"{kind_a}(A) vs {kind_b}(B)", "win_rate_A": round(rate, 4),
                                          "se": round(se, 4), "games": n, "mc_max": mc_max}
            print(f"[{tag}@{mc_max}] {kind_a} vs {kind_b}: {rate:.3f} ± {se:.3f} over {n} games "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=2))
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
