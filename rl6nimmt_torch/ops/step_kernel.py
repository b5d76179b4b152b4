"""K1: batched turn resolution (port of ``rl6nimmt_tpu/ops/step_kernel.py``).

``resolve_turn(cfg, board[G,R,T], row_len[G,R], actions[G,P]) -> (board',
row_len', rewards[G,P])`` resolves one simultaneous turn for every game: the
P sub-plays in ascending card order.  On a CUDA tensor it launches
``csrc/step_kernel.cu`` (one thread per game, the cards sorted in-thread);
on a CPU tensor it runs the plain twin :func:`resolve_turn_plain`, which is
bit-identical.  Any G works: there is no tile multiple.
"""

from __future__ import annotations

import torch

from ..engine.env import _resolve
from ..engine.state import EnvConfig
from . import _build


def resolve_turn_plain(cfg: EnvConfig, board, row_len, actions):
    """Plain PyTorch twin of K1 (the JAX ``engine.step`` resolution)."""
    actions = actions.to(torch.int32)
    order = torch.argsort(actions, dim=1)
    cards = torch.gather(actions, 1, order)
    rewards = torch.zeros_like(actions)
    players = torch.arange(cfg.num_players, device=actions.device)
    for i in range(cfg.num_players):
        board, row_len, penalty = _resolve(cfg, board, row_len, cards[:, i])
        rewards = rewards - torch.where(players[None, :] == order[:, i : i + 1], penalty[:, None], 0)
    return board, row_len, rewards.to(torch.int32)


def _check(cfg: EnvConfig, board, row_len, actions):
    G = board.shape[0]
    P, R, T = cfg.num_players, cfg.num_rows, cfg.threshold
    for name, x, shape in (("board", board, (G, R, T)), ("row_len", row_len, (G, R)),
                           ("actions", actions, (G, P))):
        if tuple(x.shape) != shape:
            raise ValueError(f"resolve_turn: {name} has shape {tuple(x.shape)}, expected {shape}")
        if x.dtype != torch.int32:
            raise TypeError(f"resolve_turn: {name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"resolve_turn: {name} must be contiguous")
        if x.device != board.device:
            raise ValueError("resolve_turn: all inputs must be on one device")
    if P > 16 or R > 8 or T > 8:
        raise ValueError("resolve_turn kernel supports P <= 16, R <= 8, T <= 8")


def resolve_turn(cfg: EnvConfig, board, row_len, actions):
    """K1 on a CUDA tensor, the plain twin on a CPU tensor."""
    if board.device.type == "cpu":
        return resolve_turn_plain(cfg, board, row_len, actions)
    if board.device.type != "cuda":
        raise ValueError(f"resolve_turn: unsupported device {board.device}")
    _check(cfg, board, row_len, actions)
    G = board.shape[0]
    board_out = torch.empty_like(board)
    len_out = torch.empty_like(row_len)
    rewards = torch.empty_like(actions)
    if G == 0:
        return board_out, len_out, rewards
    code = _build.library().rl6_resolve_turn(
        board.data_ptr(), row_len.data_ptr(), actions.data_ptr(),
        board_out.data_ptr(), len_out.data_ptr(), rewards.data_ptr(),
        G, cfg.num_players, cfg.num_rows, cfg.threshold,
        _build.stream_ptr(board.device),
    )
    _build.check(code, "resolve_turn")
    _build.LAUNCHES["resolve_turn"] += 1
    return board_out, len_out, rewards
