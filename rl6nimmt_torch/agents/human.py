"""Interactive CLI agent (port of ``agents/human.py``; the reference's ``Human``, human.py:7-33).

Prompts on stdin for a 1-indexed card face until the player names a card they
actually hold.  A host-side agent of the game session; device blocks route
its games through the host block driver.
"""

from __future__ import annotations

import logging

from .base import Agent

logger = logging.getLogger(__name__)


def prompt_for_card(legal_actions, name: str) -> int:
    """The reference prompt/retry loop (human.py:14-28): 1-indexed card faces,
    re-prompt until a held card is named."""
    hand = " ".join(f"{card + 1:>3d}" for card in legal_actions)
    prompt = f"It is your turn, {name}! You have the following cards: {hand}. Choose one to play!"
    action = -1
    while action not in legal_actions:
        raw = input(prompt)
        try:
            action = int(raw) - 1
        except (TypeError, ValueError):
            logger.error("Input in wrong format, please try again.")
        prompt = "You don't have that card. Please pick one of your cards: " + hand
    return action


class Human(Agent):
    def __init__(self, name: str = "Human", env=None, *args, **kwargs):
        super().__init__(env, *args, **kwargs)
        self.__name__ = name

    def forward(self, state, legal_actions, **kwargs):
        action = prompt_for_card(list(legal_actions), self.__name__)
        return action, {}

    def learn(self, *args, **kwargs):
        return 0.0
