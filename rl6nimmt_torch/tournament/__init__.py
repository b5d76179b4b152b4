"""Population tournament with ELO (port of ``rl6nimmt_tpu.tournament``)."""

from .elo import EloPlayer, calc_elo
from .tournament import Tournament

__all__ = ["EloPlayer", "calc_elo", "Tournament"]
