"""The runtime (port of ``rl6nimmt_tpu.runtime``): the vectorized self-play
cycles (``vector``), the device search match, the game session, the host and
device tournament blocks, the device learner updates and the arena.  The
package exports JAX's names; the rest live in their modules."""

from .arena import SeatPolicy, make_arena, play_match, seat_policy_of
from .device_match import make_device_match_fn
from .session import GameSession

__all__ = [
    "GameSession",
    "SeatPolicy",
    "make_arena",
    "make_device_match_fn",
    "play_match",
    "seat_policy_of",
]
