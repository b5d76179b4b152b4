"""Strength equivalence of device-root and host-root search decisions.

    python -m rl6nimmt_torch.experiments.devroot_equivalence [--agent puct|mcs|policy_mcs] [--games 200]
        [--mc-max 200] [--seed 0] [--device cuda]

Port of ``experiments/devroot_equivalence.py``.  The device-root decision
(``device_root=True``: the whole search in ``agents/device_search.py``) and
the host-root one (the root on the host, each round's playouts one call) run
the same rounds and root rules on different random streams.  The two
variants of one agent play two-seat ``GameSession`` games with the seats
alternated; if they are equally strong the device-root win rate (ties half)
is 0.5.  Prints the running rate every 50 games and a JSON line with the
rate, its z against 0.5 (binomial SE under the null) and a verdict (``|z| <
2``: equivalent), and returns that dict.  ``--device`` takes the place of
JAX's ``--platform``: the card unless ``--device cpu``, with no silent
fallback.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def equivalence(wins_d: float, n: int):
    """The device-root win rate, its z against 0.5 and the verdict."""
    rate = wins_d / n
    se = (0.25 / n) ** 0.5      # binomial SE under the null p = 0.5
    z = (rate - 0.5) / se
    return rate, z, "equivalent (|z| < 2)" if abs(z) < 2 else "SIGNIFICANT DIFFERENCE"


def main(argv=None):
    from ..agents import MCSAgent, PolicyMCSAgent, PUCTAgent
    from ..runtime.session import GameSession
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--agent", choices=["puct", "mcs", "policy_mcs"], default="puct")
    parser.add_argument("--games", type=int, default=200)
    parser.add_argument("--mc-max", type=int, default=200)
    parser.add_argument("--device", "--platform", dest="device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if args.games <= 0:
        parser.error("--games must be positive")
    dev = resolve_device(args.device)
    np.random.seed(args.seed)

    cls = {"puct": PUCTAgent, "mcs": MCSAgent, "policy_mcs": PolicyMCSAgent}[args.agent]
    device = cls(mc_max=args.mc_max, device_root=True, seed=args.seed + 1, device=dev)
    host = cls(mc_max=args.mc_max, device_root=False, seed=args.seed + 2, device=dev)

    # Eval mode: no learning, the playing strength alone.
    scores_d, scores_h, wins_d = [], [], 0.0
    for g in range(args.games):
        agents = [device, host] if g % 2 == 0 else [host, device]
        session = GameSession(*agents, device=dev)
        session.play_game()
        s = np.asarray(session.results[-1], np.float64)
        d, h = (s[0], s[1]) if g % 2 == 0 else (s[1], s[0])
        scores_d.append(d)
        scores_h.append(h)
        wins_d += 1.0 if d > h else (0.5 if d == h else 0.0)
        if (g + 1) % 50 == 0:
            print(f"{g+1:>4} games: device-root win rate {wins_d/(g+1):.3f}, "
                  f"mean {np.mean(scores_d):.2f} vs {np.mean(scores_h):.2f}", flush=True)

    n = args.games
    rate, z, verdict = equivalence(wins_d, n)
    out = {
        "agent": args.agent,
        "mc_max": args.mc_max,
        "games": n,
        "device_root_win_rate": rate,
        "z_vs_null_0.5": z,
        "mean_score_device": float(np.mean(scores_d)),
        "mean_score_host": float(np.mean(scores_h)),
        "verdict": verdict,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
