"""Smoke script: the flagship DQN against a random agent, one rendered game.

    python -m rl6nimmt_torch.experiments.debug_dqn [--device cuda]

Port of ``experiments/debug_dqn.py``: a ``Noisy_D3QN_PRB_NStep`` (history
1,000, 3 steps, minibatch 16, seed 0) in training mode against
``DrunkHamster(seed=1)`` in a host ``GameSession`` for 2 games at DEBUG
logging, the last one rendered.  ``--platform`` is an alias of ``--device``
(the card unless ``--device cpu``).  Prints and returns the session's
results.
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None):
    from ..agents import DrunkHamster, Noisy_D3QN_PRB_NStep
    from ..runtime.session import GameSession
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", "--platform", dest="device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    logging.basicConfig(format="%(message)s", level=logging.DEBUG)

    agent = Noisy_D3QN_PRB_NStep(history_length=1000, n_steps=3, minibatch=16, seed=0, device=dev)
    agent.train()
    session = GameSession(agent, DrunkHamster(seed=1, device=dev), device=dev)
    for g in range(2):
        session.play_game(render=(g == 1))
    print("results:", session.results)
    return session.results


if __name__ == "__main__":
    main()
