"""Alpha0.5 with a bigger playout budget against reference-budget opponents.

    python -m rl6nimmt_torch.experiments.strength_vs_budget [--games 100] [--big 800] [--small 400]
        [--opponent puct|mcs] [--seed 0] [--device cuda]

Port of ``experiments/strength_vs_budget.py``: two-seat ``GameSession`` games
(the host driver, the tournament's path) between a ``PUCTAgent`` at
``--big`` playouts and a ``PUCTAgent`` or ``MCSAgent`` at ``--small``, the
seats alternated game by game.  Prints the running win rate every 10 games
and a final line with the big budget's win rate (ties count half) and both
mean scores.  The JAX script defaulted to the host CPU; this one runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    from ..agents import MCSAgent, PUCTAgent
    from ..runtime.session import GameSession
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--games", type=int, default=100)
    parser.add_argument("--big", type=int, default=800)
    parser.add_argument("--small", type=int, default=400)
    parser.add_argument("--opponent", choices=["puct", "mcs"], default="puct")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.games <= 0:
        parser.error("--games must be positive")
    dev = resolve_device(args.device)
    np.random.seed(args.seed)

    big = PUCTAgent(mc_max=args.big, seed=args.seed + 1, device=dev)
    opponent = PUCTAgent if args.opponent == "puct" else MCSAgent
    small = opponent(mc_max=args.small, seed=args.seed + 2, device=dev)
    name_b, name_s = f"Alpha0.5@{args.big}", f"{args.opponent}@{args.small}"

    wins, totals = np.zeros(2), np.zeros(2)
    for g in range(args.games):
        agents = [big, small] if g % 2 == 0 else [small, big]     # alternate seats against seat bias
        session = GameSession(*agents, device=dev)
        session.play_game()
        scores = np.asarray(session.results[-1], dtype=np.float64)
        if g % 2 == 1:
            scores = scores[::-1]                                  # back to [big, small]
        totals += scores
        wins += (0.5, 0.5) if scores[0] == scores[1] else ((1, 0) if scores[0] > scores[1] else (0, 1))
        if (g + 1) % 10 == 0:
            print(f"game {g + 1:>4}: {name_b} wins {wins[0]:.1f} ({wins[0] / (g + 1):.2f}), mean "
                  f"{totals[0] / (g + 1):+.2f} vs {name_s} {totals[1] / (g + 1):+.2f}", flush=True)
    n = args.games
    print(f"FINAL {name_b} vs {name_s} over {n} games: win rate {wins[0] / n:.3f}, mean scores "
          f"{totals[0] / n:+.2f} vs {totals[1] / n:+.2f}", flush=True)
    return {"win_rate": wins[0] / n, "mean_scores": (totals / n).tolist(), "games": n}


if __name__ == "__main__":
    main()
