"""Card point ("Hornochsen") tables (port of ``engine/cards.py``).

Face value is ``card_id + 1``: 55 -> 7, multiples of 11 -> 5, multiples of
10 -> 3, faces ending in 5 -> 2, everything else -> 1 (reference
env.py:224-239).
"""

from __future__ import annotations

import numpy as np

NUM_CARDS_DEFAULT = 104

# Sigils the renderer marks card point values with (reference env.py:241-244).
VALUE_SIGILS = {1: " ", 2: ".", 3: ":", 5: "+", 7: "#"}


def card_points(card_id: int) -> int:
    """Point value of a single 0-indexed card id (face value ``card_id + 1``)."""
    face = card_id + 1
    if face == 55:
        return 7
    if face % 11 == 0:
        return 5
    if face % 10 == 0:
        return 3
    if face % 10 == 5:
        return 2
    return 1


def build_points_table(num_cards: int = NUM_CARDS_DEFAULT) -> np.ndarray:
    """Dense ``int32[num_cards]`` lookup table of card point values."""
    return np.asarray([card_points(c) for c in range(num_cards)], dtype=np.int32)


POINTS_104 = build_points_table(NUM_CARDS_DEFAULT)


def format_card(card_id: int) -> str:
    """Render a card as ``'<face><sigil>'`` right-aligned (reference env.py:241-244)."""
    return f"{card_id + 1:>3d}{VALUE_SIGILS[card_points(card_id)]}"
