"""Recorded-seed parity harness (the port's own copy of ``parity/harness.py``;
numpy only).

The reference deals by mutating the *global* NumPy RNG
(the reference env.py:99-112): ``cards = arange(num_cards);
np.random.shuffle(cards)``; players then take consecutive 10-card slices and
each board row pops from the tail.  The port's engine deals from Philox
seeds instead -- so bit-exact trajectory comparison against the reference at a
fixed seed works by *replaying the reference's shuffles*:

* :func:`reference_deck` reproduces the exact deck the reference would deal
  after ``np.random.seed(seed)`` (plus any number of prior deals consuming
  the same RNG stream);
* feed that deck to ``SechsNimmtEnv.reset_with_deck`` /
  ``engine.init_from_deck`` (both honor the reference's slice/tail layout)
  and to ``ParityEnv.reset_with_deck`` -- identical games fall out.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np


def reference_deck(
    seed: Optional[int] = None,
    num_cards: int = 104,
    skip_deals: int = 0,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """The deck order the reference env would deal.

    ``skip_deals`` advances the RNG stream past earlier games (each reference
    deal consumes exactly one ``shuffle`` of ``num_cards`` elements).
    """
    if rng is None:
        rng = np.random.RandomState(seed)
    deck = np.arange(num_cards, dtype=np.int64)
    for _ in range(skip_deals):
        rng.shuffle(deck)
        deck = np.arange(num_cards, dtype=np.int64)
    rng.shuffle(deck)
    return deck


def reference_deck_stream(
    seed: Optional[int], num_cards: int = 104
) -> Iterator[np.ndarray]:
    """Infinite stream of decks as successive reference games would deal them."""
    rng = np.random.RandomState(seed)
    while True:
        deck = np.arange(num_cards, dtype=np.int64)
        rng.shuffle(deck)
        yield deck


def reference_hands_and_board(deck: np.ndarray, num_players: int, num_rows: int = 4,
                              hand_size: int = 10):
    """Split a deck into (hands, board_rows) with the reference layout."""
    hands: List[List[int]] = [
        sorted(int(c) for c in deck[p * hand_size : (p + 1) * hand_size])
        for p in range(num_players)
    ]
    tail = deck[num_players * hand_size :]
    board = [[int(tail[len(tail) - 1 - r])] for r in range(num_rows)]
    return hands, board
