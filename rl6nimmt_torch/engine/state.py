"""Game configuration and the batched game state (port of ``engine/state.py``).

``EnvConfig`` keeps the JAX fields and properties.  ``EnvState`` is a
dataclass of tensors that always carries a leading games axis ``G`` (the
JAX package vmapped an unbatched state; here the batch is written out).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class EnvConfig:
    """Static game parameters (mirrors the reference constructor, env.py:16-27)."""

    num_players: int
    num_rows: int = 4
    num_cards: int = 104
    threshold: int = 6
    include_summaries: bool = True
    hand_size: int = 10

    def __post_init__(self):
        if self.num_players <= 0 or self.num_rows <= 0:
            raise ValueError("num_players and num_rows must be positive")
        if self.num_cards < self.hand_size * self.num_players + self.num_rows:
            raise ValueError("not enough cards for the hands and the board")

    @property
    def state_length(self) -> int:
        """Per-player observation length (reference env.py:37): 47 by default."""
        summaries = 3 * self.num_rows if self.include_summaries else 0
        return self.hand_size + 1 + summaries + self.num_rows * self.threshold

    @property
    def num_actions(self) -> int:
        return self.num_cards

    @property
    def max_turns(self) -> int:
        return self.hand_size


@dataclass
class EnvState:
    """A batch of ``G`` games.

    board:        int32[G, R, T]  card ids, -1 for empty slots.
    row_len:      int32[G, R]     cards in each row.
    hands:        bool[G, P, C]   card-membership mask per player.
    hands_sorted: int32[G, P, H]  ascending card ids, -1 padded.
    scores:       int32[G, P]     accumulated penalty points (positive).
    turn:         int32[G]        completed simultaneous turns.
    """

    board: torch.Tensor
    row_len: torch.Tensor
    hands: torch.Tensor
    hands_sorted: torch.Tensor
    scores: torch.Tensor
    turn: torch.Tensor
