"""Batched 6 nimmt! engine (port of ``rl6nimmt_tpu.engine``)."""

from .cards import POINTS_104, build_points_table, card_points, format_card
from .env import (
    InvalidMoveException,
    card_points_formula,
    deal,
    init_from_deck,
    is_done,
    legal_mask,
    observe,
    row_points,
    state_from_deal,
    step,
)
from .state import EnvConfig, EnvState
from .wrapper import SechsNimmtEnv

__all__ = [
    "EnvConfig",
    "EnvState",
    "InvalidMoveException",
    "POINTS_104",
    "SechsNimmtEnv",
    "build_points_table",
    "card_points",
    "card_points_formula",
    "deal",
    "format_card",
    "init_from_deck",
    "is_done",
    "legal_mask",
    "observe",
    "row_points",
    "state_from_deal",
    "step",
]
