"""Uniform-random agent (port of ``agents/random_agent.py``; the reference's ``DrunkHamster``, random.py:5-13).

It draws from NumPy's global generator, as the JAX agent does, so a seeded
``np.random`` gives both the same cards.
"""

from __future__ import annotations

import numpy as np

from .base import Agent


class DrunkHamster(Agent):
    """Plays a uniformly random legal card; never learns."""

    def forward(self, state, legal_actions, **kwargs):
        action = int(np.random.choice(np.asarray(legal_actions, dtype=np.int64)))
        return action, {}

    def learn(self, *args, **kwargs):
        return 0.0
