"""The yardstick: the card's published peaks, and the operations and bytes that
the measured work needs, computed from shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at 700 W): 3.35 TB/s of
HBM, 67 TFLOP/s in float32 outside the tensor cores (the configurations
compute in float32 with TF32 off).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


# One sub-play of K1 (csrc/step_kernel.cu): the row search and the cheapest row over
# R = 4 rows, then the row's update; integer work is charged at the float32 rate.
SUBPLAY_OPS = 6 * 4 + 10


def k1_ops(games: int, players: int) -> int:
    """One K1 launch's operations: P sub-plays a game, and the P x P ordering of its cards."""
    return games * (players * SUBPLAY_OPS + players * players)


def k1_bytes(games: int, players: int, rows: int, threshold: int) -> int:
    """One K1 launch (a turn's resolution): board, row lengths and actions read
    once, board, row lengths and rewards written once, all int32."""
    return 4 * games * (rows * threshold + rows + players) * 2


def policy_flops(net: dict, seats: int, hand: int) -> float:
    """The action-in-input forward of one game's turns for ``seats`` seats:
    at turn ``t`` a seat holds ``hand - t`` cards.  The first layer's state part
    is one product a seat and turn (``2 (in - 1) h1``); each live card adds the
    rank-1 action term (``2 h1``) and the later layers (``2 h_i h_{i+1}`` each)."""
    dims = [int(net["input_size"])] + [int(h) for h in net["hidden_sizes"]]
    heads = [int(h) for h in net["head_sizes"]]
    shared = 2 * (dims[0] - 1) * dims[1]
    per_card = 2 * dims[1] + sum(2 * a * b for a, b in zip(dims[1:-1], dims[2:])) + sum(2 * dims[-1] * h for h in heads)
    live = sum(hand - t for t in range(hand))
    return float(seats) * (hand * shared + live * per_card)


def mlp_flops(net: dict, rows: int) -> float:
    """A plain MLP forward on ``rows`` rows: ``2 in out`` a layer and row."""
    dims = [int(net["input_size"])] + [int(h) for h in net["hidden_sizes"]]
    layers = list(zip(dims[:-1], dims[1:])) + [(dims[-1], int(h)) for h in net["head_sizes"]]
    return float(rows) * sum(2 * a * b for a, b in layers)
