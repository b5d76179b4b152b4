"""Tournament CLI (port of ``cli/run.py``; the reference run.py, with a real flag system).

The reference configures everything with inline constructor kwargs and has no
CLI; this driver exposes the same experiment as flags, on the card by default:

    python -m rl6nimmt_torch.cli.run --agents acer mcts puct --games 400 --block 100
    python -m rl6nimmt_torch.cli.run --agents random d3qn_prb_nstep --games 50 --evolve-every 25
    python -m rl6nimmt_torch.cli.run --device-blocks --block 32 --games 96

``--device cpu`` plays on the CPU (the plain twins of the kernels).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np


def build_agent(name: str, mc_max: int, seed: int, device_root: bool = False, device="cuda"):
    from ..agents import AGENTS, BaseMCAgent, PUCTCustomedAgent

    # The reference's run.py builds PUCTCustomedAgent directly (it is
    # exported but absent from AGENTS, mirroring agents/__init__.py).
    cls = PUCTCustomedAgent if name == "puct_customed" else AGENTS[name]
    kwargs = {"seed": seed, "device": device}
    if issubclass(cls, BaseMCAgent):
        kwargs["mc_max"] = mc_max
        kwargs["device_root"] = device_root
    if name == "noisy_d3qn_prb_nstep" or name == "d3qn_prb_nstep":
        kwargs.update(history_length=100_000, n_steps=10)
    return cls(**kwargs)


def main(argv=None):
    parser = argparse.ArgumentParser(description="6 nimmt! population tournament")
    parser.add_argument("--agents", nargs="+", default=["random", "acer", "mcts", "puct"],
                        help="registry names (see rl6nimmt_torch.agents.AGENTS), plus 'puct_customed' "
                             "(exported but unregistered, as in the reference)")
    parser.add_argument("--games", type=int, default=400)
    parser.add_argument("--block", type=int, default=100, help="games between table prints")
    parser.add_argument("--min-players", type=int, default=2)
    parser.add_argument("--max-players", type=int, default=4)
    parser.add_argument("--mc-max", type=int, default=200, help="search playouts per decision")
    parser.add_argument("--elo-k", type=float, default=32)
    parser.add_argument("--evolve-every", type=int, default=0, help="run evolve() every N games (0 = never)")
    parser.add_argument("--evolve-max-players", type=int, default=6)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="pickle path: loaded if it exists, saved every block")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lockstep", action="store_true",
                        help="play each block in lockstep with cross-game batched search playouts "
                             "(Tournament.play_block; evolve cadence is respected at block boundaries)")
    parser.add_argument("--device-root", action="store_true",
                        help="run each search decision as one device decision (agents/device_search.py)")
    parser.add_argument("--device-blocks", action="store_true",
                        help="run every lineup (random/search AND learner seats) as COMPLETE games on the "
                             "device, one block per player count (Tournament.play_device_block); implies "
                             "lockstep chunking")
    parser.add_argument("--device-learning", action="store_true",
                        help="with --device-blocks: the DQN, ACER and REINFORCE learners' updates on the "
                             "device too (runtime/device_learn.py)")
    parser.add_argument("--device", "--platform", dest="device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    from ..tournament import Tournament
    from ..utils.checkpoint import load_checkpoint, save_checkpoint
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    logging.basicConfig(format="%(message)s", level=logging.DEBUG if args.verbose else logging.INFO)
    np.random.seed(args.seed)

    if args.checkpoint and Path(args.checkpoint).exists():
        tournament = load_checkpoint(args.checkpoint)
        print(f"Resumed from {args.checkpoint} at {tournament.total_games} games")
    else:
        tournament = Tournament(min_players=args.min_players, max_players=args.max_players, elo_k=args.elo_k,
                                device=device)
        for i, name in enumerate(args.agents):
            agent = build_agent(name, args.mc_max, seed=args.seed + i,
                                device_root=args.device_root or args.device_blocks, device=device)
            agent.train()
            tournament.add_player(f"{name}", agent)

    def maybe_evolve():
        if args.evolve_every and tournament.total_games % args.evolve_every == 0 \
                and tournament.total_games < args.games:
            tournament.evolve(copies=(2,), max_players=args.evolve_max_players, max_per_descendant=2)

    print(tournament)
    while tournament.total_games < args.games:
        chunk = min(args.block, args.games - tournament.total_games)
        if args.lockstep or args.device_blocks:
            if args.evolve_every:  # stop lockstep chunks at evolve boundaries
                chunk = min(chunk, args.evolve_every - tournament.total_games % args.evolve_every)
            if args.device_blocks:
                bucket = 1 << (args.block - 1).bit_length()
                tournament.play_device_block(chunk, bucket=bucket, device_learning=args.device_learning)
            else:
                tournament.play_block(chunk)
            maybe_evolve()
        else:
            for _ in range(chunk):
                tournament.play_game()
                maybe_evolve()
        print(tournament)
        if args.checkpoint:
            save_checkpoint(args.checkpoint, tournament)

    winner = tournament.winner()
    print(f"Winner: {getattr(winner, '__name__', type(winner).__name__)}")
    return tournament


if __name__ == "__main__":
    main()
