"""Recorded-seed parity harness and the numpy rules oracle (port of
``rl6nimmt_tpu.parity``, less ``refload.py``, which loads the reference
package's sources from outside the repository)."""

from .harness import reference_deck, reference_deck_stream, reference_hands_and_board
from .refenv import IllegalMoveError, ParityEnv

__all__ = [
    "IllegalMoveError",
    "ParityEnv",
    "reference_deck",
    "reference_deck_stream",
    "reference_hands_and_board",
]
