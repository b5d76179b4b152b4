"""Play against Alpha0.5 on the command line.

    python -m rl6nimmt_torch.experiments.play_human [--games 5] [--mc-max 800] [--name Human]
        [--checkpoint PICKLE] [--prior-params NPZ] [--device-root] [--device-game] [--device cuda]

Port of ``experiments/play_human.py`` (the reference notebook's finale: five
rendered games of a human against a PUCT agent at mc_max 800).  A ``Human``
(cards typed on stdin, 1-indexed faces) plays a ``PUCTAgent`` through a
``GameSession``; ``--checkpoint`` loads a pickled tournament
(``utils.load_checkpoint``) whose best agent becomes the opponent,
``--prior-params`` an npz of trained prior-net params
(``train_puct_prior.py --out``).  ``--device-game`` plays each game through
``runtime/callback_human.py`` instead: every Alpha0.5 decision stays on the
card, and only the human's card crosses to the host.  Reads stdin only
through ``input()``, so a scripted stdin plays it.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging

import torch


def main(argv=None):
    from ..agents import Human, PUCTAgent
    from ..runtime.session import GameSession
    from ..utils import load_checkpoint, load_params
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--name", default="Human")
    parser.add_argument("--games", type=int, default=5)
    parser.add_argument("--mc-max", type=int, default=800)
    parser.add_argument("--checkpoint", default=None, help="tournament pickle; its best agent becomes the opponent")
    parser.add_argument("--device-root", action="store_true",
                        help="run each Alpha0.5 decision as one device program (agents/device_search.py)")
    parser.add_argument("--prior-params", default=None,
                        help="npz of trained prior-net params for Alpha0.5 (train_puct_prior.py --out)")
    parser.add_argument("--device-game", action="store_true",
                        help="play each game on the card; only your card choice crosses to the host "
                             "(runtime/callback_human.py)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    logging.basicConfig(format="%(message)s", level=logging.INFO)

    if args.device_game:
        from ..engine import EnvConfig
        from ..nets import MLPSpec, mlp_init
        from ..runtime.callback_human import play_callback_game

        params = None
        if args.prior_params:
            cfg = EnvConfig(num_players=2)
            spec = MLPSpec(input_size=cfg.state_length + 1, hidden_sizes=(100, 100), head_sizes=(1,))
            params = load_params(args.prior_params, mlp_init(torch.Generator(device=dev).manual_seed(0), spec, dev))
        totals = None
        for g in range(args.games):
            scores = play_callback_game(["puct"], params=params, mc_max=args.mc_max, seed=g, name=args.name,
                                        device=dev)
            totals = scores if totals is None else totals + scores
        print(f"Series total: {args.name} {totals[0]:.0f} vs Alpha0.5 {totals[1]:.0f}", flush=True)
        return totals

    if args.checkpoint:
        opponent = load_checkpoint(args.checkpoint).winner()
        print(f"Loaded opponent {getattr(opponent, '__name__', '?')} from {args.checkpoint}", flush=True)
    else:
        opponent = PUCTAgent(mc_max=args.mc_max, device_root=args.device_root, device=dev)
        opponent.__name__ = "Alpha0.5"
        if args.prior_params:
            opponent.set_parameters(load_params(args.prior_params, opponent.params))
            print(f"Loaded trained prior from {args.prior_params}", flush=True)
    if hasattr(opponent, "mc_max"):
        opponent.mc_max = args.mc_max
    if hasattr(opponent, "eval"):
        opponent.eval()

    session = GameSession(Human(args.name, device=dev), opponent, device=dev)
    for _ in range(args.games):
        session.play_game(render=True)
    totals = sum(session.results)
    print(f"Series total: {args.name} {totals[0]} vs {opponent.__name__} {totals[1]}", flush=True)
    return totals


if __name__ == "__main__":
    main()
