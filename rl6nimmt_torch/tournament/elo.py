"""Multi-player ELO (port of ``tournament/elo.py``; NumPy only, so the port keeps its own copy).

Reimplements the semantics of the external ``multi_elo`` package the
reference depends on (tournament.py:157-164): every player is compared
pairwise against every other player; the actual score per pair is 1 / 0.5 / 0
for a better / equal / worse placement, the expected score is the logistic
ELO formula, and the K-factor is scaled by ``1 / (n_players - 1)`` so a game
against n-1 opponents moves ratings about as much as one two-player game.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class EloPlayer:
    place: float  # lower is better
    elo: float


def calc_elo(players: Sequence[EloPlayer], k: float = 32.0) -> np.ndarray:
    """New ratings after one multi-player game (pairwise-update scheme)."""
    n = len(players)
    if n < 2:
        return np.asarray([p.elo for p in players], dtype=np.float64)
    k_pair = k / (n - 1)

    places = np.asarray([p.place for p in players], dtype=np.float64)
    elos = np.asarray([p.elo for p in players], dtype=np.float64)

    # Pairwise actual scores: 1 if better placed, 0.5 tie, 0 if worse.
    better = (places[:, None] < places[None, :]).astype(np.float64)
    tie = (places[:, None] == places[None, :]).astype(np.float64)
    actual = better + 0.5 * tie
    np.fill_diagonal(actual, 0.0)

    expected = 1.0 / (1.0 + 10.0 ** ((elos[None, :] - elos[:, None]) / 400.0))
    np.fill_diagonal(expected, 0.0)

    return elos + k_pair * np.sum(actual - expected, axis=1)
