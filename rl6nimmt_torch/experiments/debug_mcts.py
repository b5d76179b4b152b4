"""Smoke script: Alpha0.5 (PUCT) against a random agent, one rendered game.

    python -m rl6nimmt_torch.experiments.debug_mcts [--device cuda]

Port of ``experiments/debug_mcts.py``: ``PUCTAgent(mc_max=32,
mc_per_card=4, batch_playouts=8, seed=0)`` in training mode against
``DrunkHamster(seed=1)`` in a host ``GameSession``, one rendered game at
DEBUG logging.  ``--platform`` is an alias of ``--device`` (the card unless
``--device cpu``).  Prints and returns the session's results.
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None):
    from ..agents import DrunkHamster, PUCTAgent
    from ..runtime.session import GameSession
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", "--platform", dest="device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    logging.basicConfig(format="%(message)s", level=logging.DEBUG)

    agent = PUCTAgent(mc_max=32, mc_per_card=4, batch_playouts=8, seed=0, device=dev)
    agent.train()
    session = GameSession(agent, DrunkHamster(seed=1, device=dev), device=dev)
    session.play_game(render=True)
    print("results:", session.results)
    return session.results


if __name__ == "__main__":
    main()
