"""Throughput of whole device matches on the card, beside the host match driver.

    python -m rl6nimmt_torch.experiments.device_match_bench [--games 128] [--per-call 32]
        [--mc-max 200] [--players 2] [--roster puct uniform] [--host-games 16] [--seed 0]

Port of ``experiments/device_match_bench.py``: plays ``--games`` complete
matches, ``--per-call`` at a time, through
:func:`..runtime.device_match.make_device_match_fn` (K2 deals, every match
and playout turn one K1 launch), with random (100, 100) policy nets made from
``--seed`` for the seats that need one.  The first call is timed apart
(``first_call_s``: the kernels' build and first launches); the rest give
seconds per match and matches per second on the host clock, each call ending
with its scores on the host.  ``--host-games`` games of the same roster then
run through the host match driver (a :class:`..runtime.session.GameSession`
of the host agents with device-root decisions, one warm-up game first), for
seconds per match beside the device path's.  Prints one JSON line with the
card's name and power limit.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..engine import EnvConfig
from ..nets import MLPSpec, mlp_init
from ..runtime.device_match import make_device_match_fn
from ..utils.device import resolve_device
from .kernel_times import smi_line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--games", type=int, default=128)
    parser.add_argument("--per-call", type=int, default=32)
    parser.add_argument("--mc-max", type=int, default=200)
    parser.add_argument("--players", type=int, default=2)
    parser.add_argument("--roster", nargs="+", default=["puct", "uniform"])
    parser.add_argument("--host-games", type=int, default=16,
                        help="games for the host-driver comparison (0 = skip)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if len(args.roster) != args.players:
        parser.error(f"--roster names {len(args.roster)} seats for {args.players} players")
    dev = resolve_device(args.device)

    cfg = EnvConfig(num_players=args.players)
    spec = MLPSpec(input_size=cfg.state_length + 1, head_sizes=(1,))
    needs_net = [k in ("policy", "puct", "puct_uniform") for k in args.roster]
    params = tuple(mlp_init(torch.Generator(device=dev).manual_seed(args.seed + i), spec, dev) if need else None
                   for i, need in enumerate(needs_net))
    fn = make_device_match_fn(cfg, tuple(args.roster), spec if any(needs_net) else None,
                              num_games=args.per_call, mc_max=args.mc_max, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 100)

    t0 = time.perf_counter()
    fn(params, gen).cpu()
    first_call_s = time.perf_counter() - t0

    all_scores = []
    t0 = time.perf_counter()
    for _ in range(max(1, args.games // args.per_call)):
        all_scores.append(fn(params, gen).cpu())
    dt = time.perf_counter() - t0
    scores = torch.cat(all_scores)
    n = scores.shape[0]
    win0 = (float((scores[:, 0] > scores[:, 1]).float().mean() + 0.5 * (scores[:, 0] == scores[:, 1]).float().mean())
            if args.players == 2 else None)

    host_dt = None
    if args.host_games:
        from ..agents import DrunkHamster, MCSAgent, PolicyMCSAgent, PUCTAgent, PUCTUniformAgent
        from ..runtime.session import GameSession

        cls = {"random": DrunkHamster, "uniform": MCSAgent, "policy": PolicyMCSAgent, "puct": PUCTAgent,
               "puct_uniform": PUCTUniformAgent}
        agents = [cls[kind](seed=args.seed + i, device=dev,
                            **({} if kind == "random" else {"mc_max": args.mc_max, "device_root": True}))
                  for i, kind in enumerate(args.roster)]
        session = GameSession(*agents, device=dev)
        session.play_game()  # warm
        t0 = time.perf_counter()
        for _ in range(args.host_games):
            session.play_game()
        host_dt = (time.perf_counter() - t0) / args.host_games
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": smi_line() if dev.type == "cuda" else None,
        "roster": args.roster,
        "mc_max": args.mc_max,
        "games": n,
        "per_call": args.per_call,
        "first_call_s": first_call_s,
        "s_per_match_device": dt / n,
        "matches_per_s_device": n / dt,
        "s_per_match_host_driver": host_dt,
        "speedup_vs_host_driver": (host_dt / (dt / n)) if host_dt else None,
        "seat0_win_rate": win0,
    }))


if __name__ == "__main__":
    main()
