"""K1: batched turn resolution in two layouts (port of ``rl6nimmt_tpu/ops/step_kernel.py``).

* ``resolve_turn(cfg, board[G,R,T], row_len[G,R], actions[G,P]) -> (board',
  row_len', rewards[G,P])``: the row-major entry (``make_turn_resolver``),
  which the engine's ``step`` uses.
* ``resolve_turn_t(cfg, board_t[R*T,G], row_len_t[R,G], actions[G,P]) ->
  (board_t', row_len_t', rewards_t[P,G])``: the games-last entry
  (``make_turn_resolver_t``), for a caller that keeps the board games-last
  across a rollout (``runtime.vector``'s ``games_last`` rollout).

Both resolve every game's P sub-plays in ascending card order.  On CUDA
tensors each launches ``csrc/step_kernel.cu`` (32 games a block) and counts it
under its own name in ``_build.LAUNCHES``; on CPU tensors each runs its plain
twin, which the kernel equals bit for bit.  Any G works: the ragged block is
masked.  A launch's three outputs are views of one buffer.
``resolve_turn_t`` checks its inputs on every device; ``resolve_turn``, on
the engine's path, only before a launch.
"""

from __future__ import annotations

import torch

from ..engine.env import _resolve
from ..engine.state import EnvConfig
from . import _build

_ROW_MAJOR = _build.Launcher("rl6_resolve_turn", "resolve_turn")
_GAMES_LAST = _build.Launcher("rl6_resolve_turn_t", "resolve_turn_t")


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


def resolve_turn_t_plain(cfg: EnvConfig, board_t, row_len_t, actions):
    """Plain twin of the games-last entry: the row-major twin on the transposed state."""
    G, R, T = actions.shape[0], cfg.num_rows, cfg.threshold
    board, row_len, rewards = resolve_turn_plain(cfg, board_t.T.reshape(G, R, T), row_len_t.T, actions)
    return board.reshape(G, R * T).T.contiguous(), row_len.T.contiguous(), rewards.T.contiguous()


def _check(name: str, cfg: EnvConfig, tensors, shapes) -> None:
    """Raise unless ``board``, ``row_len`` and ``actions`` have ``shapes``, are
    contiguous int32 on one device, and the config is within the kernel's bounds."""
    device = tensors[0].device
    for arg, x, shape in zip(("board", "row_len", "actions"), tensors, shapes):
        if x.shape != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(x.shape)}, expected {shape}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if x.device != device:
            raise ValueError(f"{name}: all inputs must be on one device")
    if cfg.num_players > 16 or cfg.num_rows > 8 or cfg.threshold > 8:
        raise ValueError(f"{name} kernel supports P <= 16, R <= 8, T <= 8")


def _launch(launcher, cfg: EnvConfig, board, row_len, actions, games_last: bool):
    """One K1 launch into a fresh buffer; returns its three outputs, views of
    that buffer, each starting on a 16-byte boundary (the kernel stores 16
    bytes at a time)."""
    G, P, R, T = actions.shape[0], cfg.num_players, cfg.num_rows, cfg.threshold
    o_len = -(-G * R * T // 4) * 4
    o_rew = o_len + -(-G * R // 4) * 4
    buf = board.new_empty(o_rew + G * P)
    if games_last:
        outs = (buf.as_strided((R * T, G), (G, 1)), buf.as_strided((R, G), (G, 1), o_len),
                buf.as_strided((P, G), (G, 1), o_rew))
    else:
        outs = (buf.as_strided((G, R, T), (R * T, T, 1)), buf.as_strided((G, R), (R, 1), o_len),
                buf.as_strided((G, P), (P, 1), o_rew))
    if G:
        launcher(board.get_device(), board.data_ptr(), row_len.data_ptr(), actions.data_ptr(),
                 outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(), G, P, R, T)
    return outs


def resolve_turn(cfg: EnvConfig, board, row_len, actions):
    """K1 on a CUDA tensor, the plain twin on a CPU tensor."""
    if not board.is_cuda:
        if board.device.type == "cpu":
            return resolve_turn_plain(cfg, board, row_len, actions)
        raise ValueError(f"resolve_turn: unsupported device {board.device}")
    G, P, R, T = board.shape[0], cfg.num_players, cfg.num_rows, cfg.threshold
    _check("resolve_turn", cfg, (board, row_len, actions), ((G, R, T), (G, R), (G, P)))
    return _launch(_ROW_MAJOR, cfg, board, row_len, actions, games_last=False)


def resolve_turn_t(cfg: EnvConfig, board_t, row_len_t, actions):
    """The games-last K1 on CUDA tensors, its plain twin on CPU tensors."""
    G, P, R, T = actions.shape[0], cfg.num_players, cfg.num_rows, cfg.threshold
    _check("resolve_turn_t", cfg, (board_t, row_len_t, actions), ((R * T, G), (R, G), (G, P)))
    if not board_t.is_cuda:
        if board_t.device.type == "cpu":
            return resolve_turn_t_plain(cfg, board_t, row_len_t, actions)
        raise ValueError(f"resolve_turn_t: unsupported device {board_t.device}")
    return _launch(_GAMES_LAST, cfg, board_t, row_len_t, actions, games_last=True)
