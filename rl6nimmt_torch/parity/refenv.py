"""Independent NumPy transcription of the reference 6 nimmt! rules (the
port's own copy of ``parity/refenv.py``).

This module is the *parity oracle*: a plain-Python/NumPy reimplementation of the
exact observable behavior of the reference environment
(the reference package's env.py), written from the rules rather than ported.
It exists purely so the engine can be golden-tested against something that
is easy to audit line-by-line against the rule description in SURVEY.md §2.1.

Behavioral contract (with reference citations):

* dealing: a shuffled deck of ``num_cards`` ids; each player takes the next 10
  (kept sorted); each board row is seeded by popping from the *tail* of the
  remaining deck, row 0 first (env.py:99-112).
* step: every player simultaneously commits one card; cards resolve in
  ascending card order (env.py:120-136).
* placement: a card joins the row whose last card is the highest one below it;
  if the card undercuts every row, the row with the smallest total point value
  (including its last card, first-minimum tie-break) is captured and replaced
  (env.py:138-159).
* scoring: when a row is captured -- by undercut replacement or by receiving
  its ``threshold``-th card -- the placing player gains the summed points of
  the cards that were in the row before placement; the row restarts with just
  the placed card; the step reward for that player is minus the penalty
  (env.py:161-172).
* observation: per player, ``own hand padded to 10 with -1 | num_players |
  cards-per-row | highest-card-per-row | row-points-incl-last | board RxT
  flattened with -1 padding`` (env.py:174-212); the three summary blocks are
  dropped when ``include_summaries`` is false.
* termination: the game ends when player 0's hand is empty (env.py:246-249).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..engine.cards import build_points_table


class IllegalMoveError(Exception):
    """Raised when a player commits a card that is not in their hand."""


@dataclass
class ParityEnv:
    """Single-game rules oracle with the reference's gym-flavored API."""

    num_players: int
    num_rows: int = 4
    num_cards: int = 104
    threshold: int = 6
    include_summaries: bool = True
    hand_size: int = 10

    board: List[List[int]] = field(default_factory=list)
    hands: List[List[int]] = field(default_factory=list)
    scores: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int32))

    def __post_init__(self):
        assert self.num_players > 0 and self.num_rows > 0
        assert self.num_cards >= self.hand_size * self.num_players + self.num_rows
        self._points = build_points_table(self.num_cards)
        self.board = [[] for _ in range(self.num_rows)]
        self.hands = [[] for _ in range(self.num_players)]
        self.scores = np.zeros(self.num_players, dtype=np.int32)

    # ------------------------------------------------------------------ setup

    def reset(self, rng: Optional[np.random.RandomState] = None):
        deck = np.arange(self.num_cards, dtype=np.int64)
        (rng or np.random).shuffle(deck)
        return self.reset_with_deck(deck)

    def reset_with_deck(self, deck: Sequence[int]):
        """Deterministic deal from an explicit shuffled deck (parity mode)."""
        deck = list(int(c) for c in deck)
        assert len(deck) == self.num_cards
        for p in range(self.num_players):
            lo = p * self.hand_size
            self.hands[p] = sorted(deck[lo : lo + self.hand_size])
        # Rows are seeded from the tail of the remaining deck, row 0 first.
        tail = deck[self.num_players * self.hand_size :]
        for r in range(self.num_rows):
            self.board[r] = [tail[len(tail) - 1 - r]]
        self.scores = np.zeros(self.num_players, dtype=np.int32)
        return self._observe()

    def reset_to(self, board: Sequence[Sequence[int]], hands: Sequence[Sequence[int]]):
        """Re-enter a mid-game position (used by search determinization)."""
        self.board = [list(r) for r in board]
        self.hands = [list(h) for h in hands]
        self.scores = np.zeros(self.num_players, dtype=np.int32)
        return self._observe()

    # ------------------------------------------------------------------- step

    def step(self, actions: Sequence[int]):
        assert len(actions) == self.num_players
        for p, card in enumerate(actions):
            if card not in self.hands[p]:
                raise IllegalMoveError(
                    f"player {p} played card id {card} but holds {self.hands[p]}"
                )

        rewards = np.zeros(self.num_players, dtype=np.int32)
        for card, p in sorted((int(c), p) for p, c in enumerate(actions)):
            rewards += self._place(p, card)

        return self._observe(), rewards, self.done(), {}

    def done(self) -> bool:
        return len(self.hands[0]) == 0

    # ---------------------------------------------------------------- helpers

    def _place(self, player: int, card: int) -> np.ndarray:
        lasts = [row[-1] for row in self.board]
        below = [last for last in lasts if last < card]
        if below:
            row = lasts.index(max(below))
            captured = False
        else:
            row = int(np.argmin([self._row_points(r, include_last=True) for r in range(self.num_rows)]))
            captured = True

        self.board[row].append(card)
        self.hands[player].remove(card)

        rewards = np.zeros(self.num_players, dtype=np.int32)
        if captured or len(self.board[row]) >= self.threshold:
            penalty = sum(int(self._points[c]) for c in self.board[row][:-1])
            self.scores[player] += penalty
            rewards[player] -= penalty
            self.board[row] = [card]
        return rewards

    def _row_points(self, row: int, include_last: bool) -> int:
        cards = self.board[row]
        if not include_last and len(cards) <= 1:
            return 0
        upto = len(cards) if include_last else len(cards) - 1
        return sum(int(self._points[c]) for c in cards[:upto])

    # ----------------------------------------------------------- observations

    def _observe(self) -> Tuple[List[np.ndarray], List[List[int]]]:
        game = self._game_state()
        states, legal = [], []
        for p in range(self.num_players):
            hand = self.hands[p]
            padded = hand + [-1] * (self.hand_size - len(hand))
            states.append(np.hstack((np.asarray(padded, dtype=np.int32), game)))
            legal.append(list(hand))
        return states, legal

    def _game_state(self) -> np.ndarray:
        grid = -np.ones((self.num_rows, self.threshold), dtype=np.int32)
        for r, cards in enumerate(self.board):
            grid[r, : len(cards)] = cards

        pieces = [np.asarray([self.num_players], dtype=np.int32)]
        if self.include_summaries:
            pieces.append(np.asarray([len(r) for r in self.board], dtype=np.int32))
            pieces.append(np.asarray([r[-1] for r in self.board], dtype=np.int32))
            pieces.append(
                np.asarray(
                    [self._row_points(r, include_last=True) for r in range(self.num_rows)],
                    dtype=np.int32,
                )
            )
        pieces.append(grid.reshape(-1))
        return np.hstack(pieces)

    @property
    def state_length(self) -> int:
        summaries = 3 * self.num_rows if self.include_summaries else 0
        return self.hand_size + 1 + summaries + self.num_rows * self.threshold
