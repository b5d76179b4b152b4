"""The published experiment, as a script (port of ``experiments/simple_tournament.py``;
the reference simple_tournament.ipynb).

Five agents (Random, D3QN = Noisy_D3QN_PRB_NStep, ACER, MCS, Alpha0.5 =
PUCT), staged play with evolution, ELO K-factor annealing, pickle checkpoints
between stages, and an ELO-vs-games plot.  Flags scale it down for smoke runs;
``--device`` picks the torch device (default ``cuda``).

Stages (notebook cells 8-26):
  1. games 0..2000, mc_max=200: evolve(max_players=6, max_per_descendant=2,
     copies=(2,)) every 400 games.
  2. games ..3200, mc_max=400, elo_k=16, no more evolution.
  3. ELO fine-tune: k in {32, 16, 8, 4}, 200 games each.

    python -m rl6nimmt_torch.experiments.simple_tournament --scale 0.01 --device-blocks --block 32
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scale", type=float, default=1.0,
                        help="scale all game counts (use e.g. 0.01 for a smoke run)")
    parser.add_argument("--mc-max", type=int, default=200)
    parser.add_argument("--checkpoint-dir", type=str, default=".")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", "--platform", dest="device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    parser.add_argument("--block", type=int, default=1,
                        help="games per lockstep block (1 = sequential reference protocol; larger blocks "
                             "batch search playouts across games via Tournament.play_block)")
    parser.add_argument("--device-root", action="store_true",
                        help="run each search decision as one device decision (agents/device_search.py) "
                             "instead of host-root with per-round device playouts")
    parser.add_argument("--device-blocks", action="store_true",
                        help="run every lineup (random/search AND learner seats) as COMPLETE games on the "
                             "device, one block per player count (Tournament.play_device_block); only Human / "
                             "temperature-PUCT seats fall back to the host block driver")
    parser.add_argument("--device-learning", action="store_true",
                        help="with --device-blocks: the DQN, ACER and REINFORCE learners' updates on the "
                             "device too (runtime/device_learn.py)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest stage checkpoint in --checkpoint-dir (like the notebook "
                             "reloading its .tournament*.pickle between sessions)")
    args = parser.parse_args(argv)

    from ..tournament import Tournament
    from ..utils.checkpoint import load_checkpoint, save_checkpoint
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    logging.basicConfig(format="%(message)s", level=logging.INFO)
    for name in logging.root.manager.loggerDict:
        if "rl6nimmt" not in name:
            logging.getLogger(name).setLevel(logging.WARNING)
    np.random.seed(args.seed)

    n = lambda games: max(1, int(games * args.scale))
    ckpt = lambda tag: str(Path(args.checkpoint_dir) / f".tournament{tag}.pickle")

    def play_n(tournament, games):
        if args.device_blocks:
            block = max(args.block, 1)
            bucket = 1 << (block - 1).bit_length()
            for start in range(0, games, block):
                tournament.play_device_block(min(block, games - start), bucket=bucket,
                                             device_learning=args.device_learning)
        elif args.block <= 1:
            for _ in range(games):
                tournament.play_game()
        else:
            for start in range(0, games, args.block):
                tournament.play_block(min(args.block, games - start))

    tournament = None
    if args.resume:
        for tag in ("6", "5", "4", "3", "2", ""):
            path = Path(ckpt(tag))
            if path.exists():
                tournament = load_checkpoint(str(path))
                print(f"Resumed from {path} at {tournament.total_games} games")
                break

    if tournament is None:
        tournament = Tournament(min_players=2, max_players=4, device=device)
        for name, agent in population(args.seed, args.mc_max, args.device_root, device).items():
            agent.train()
            tournament.add_player(name, agent)
    print(tournament)

    # ------------------------------------------------- stage 1: evolve era
    while tournament.total_games < n(2000):
        play_n(tournament, min(n(400), n(2000) - tournament.total_games))
        print(tournament)
        if tournament.total_games < n(2000):
            tournament.evolve(max_players=6, max_per_descendant=2, copies=(2,))
    save_checkpoint(ckpt(""), tournament)

    # ----------------------------------- stage 2: longer search, steadier K
    for agent in tournament.agents.values():
        if hasattr(agent, "mc_max"):
            agent.mc_max = args.mc_max * 2
    tournament.elo_k = 16
    while tournament.total_games < n(3200):
        play_n(tournament, min(n(400), n(3200) - tournament.total_games))
        print(tournament)
    save_checkpoint(ckpt("2"), tournament)

    # ------------------------------------------------ stage 3: ELO annealing
    for stage, k in enumerate((32, 16, 8, 4), start=3):
        target = n(3200) + (stage - 2) * n(200)
        if tournament.total_games >= target:
            continue  # already past this stage (resume)
        tournament.elo_k = k
        play_n(tournament, target - tournament.total_games)
        print(tournament)
        save_checkpoint(ckpt(str(stage)), tournament)

    # ------------------------------------------------------------- ELO plot
    try:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        plt.figure(figsize=(8, 5))
        for name in tournament.agents:
            series = tournament.elos[name]
            plt.plot(range(len(series)), series, label=name)
        plt.xlabel("games played")
        plt.ylabel("ELO")
        plt.legend()
        plt.savefig(str(Path(args.checkpoint_dir) / "elo.png"), dpi=120)
        plt.savefig(str(Path(args.checkpoint_dir) / "elo.pdf"))
        print("wrote elo.png / elo.pdf")
    except Exception as e:  # matplotlib optional
        print(f"(skipping ELO plot: {e})")

    print(tournament)
    return tournament


def population(seed: int, mc_max: int = 200, device_root: bool = False, device="cuda") -> dict:
    """The notebook's five agents at their published widths and budgets."""
    from ..agents import BatchedACERAgent, DrunkHamster, MCSAgent, Noisy_D3QN_PRB_NStep, PUCTAgent

    return {
        "Random": DrunkHamster(seed=seed, device=device),
        "D3QN": Noisy_D3QN_PRB_NStep(history_length=int(1e5), n_steps=10, seed=seed + 1, device=device),
        "ACER": BatchedACERAgent(minibatch=10, seed=seed + 2, device=device),
        "MCS": MCSAgent(mc_max=mc_max, device_root=device_root, seed=seed + 3, device=device),
        "Alpha0.5": PUCTAgent(mc_max=mc_max, device_root=device_root, seed=seed + 4, device=device),
    }


if __name__ == "__main__":
    main()
