"""K4: whole greedy noisy-DQN games (port of ``ops/act_rollout_kernel.py``).

``make_act_rollout_kernel(cfg, num_games, hidden)`` returns ``play(seed, w1
[T,S,Hd], b1 [T,Hd], wa [T,Hd,A], ba [T,A]) -> (obs int8 [T+1,G,P,S],
actions int32 [T,G,P], rewards int32 [T,G,P])`` with ``T = cfg.max_turns``.
The games are dealt from ``seed`` by the same Philox deal as K2, so
``deal_games(seed)`` reproduces them.  Each turn every seat acts greedily on
the advantage head of that turn's effective weights (the dueling ``V -
mean(A)`` shift is a per-state constant and cannot change the argmax), over
the cards in its hand, lowest card first on ties -- ``argmax`` over the
legal-masked row.

On CUDA weights it launches ``csrc/act_rollout_kernel.cu``; on CPU weights it
runs :func:`act_rollout_plain`.  Row-major layout only (the TPU's
``feature_major`` layout was a lane-layout device).
"""

from __future__ import annotations

import torch

from ..engine.env import observe, state_from_deal, step_with
from ..engine.state import EnvConfig
from . import _build
from .game_kernel import _check_cfg, _check_seed, deal_games_plain
from .step_kernel import resolve_turn_plain

NEG_INF = -1e9
MAX_HIDDEN = 256


def act_rollout_plain(cfg: EnvConfig, seed: int, num_games: int, w1, b1, wa, ba):
    """Plain twin of K4: same deals (Philox), torch matmuls, masked argmax."""
    n_turns = cfg.max_turns
    board, row_len, hs = deal_games_plain(cfg, seed, num_games, w1.device)
    state = state_from_deal(cfg, board, row_len, hs)
    obs_all, actions_all, rewards_all = [], [], []
    for t in range(n_turns):
        obs, masks = observe(cfg, state)
        obs_all.append(obs.to(torch.int8))
        h = torch.relu(obs @ w1[t] + b1[t])
        adv = h @ wa[t] + ba[t]
        actions = torch.argmax(torch.where(masks, adv, NEG_INF), dim=-1).to(torch.int32)
        state, rewards = step_with(cfg, state, actions, resolve_turn_plain)
        actions_all.append(actions)
        rewards_all.append(rewards)
    obs_all.append(observe(cfg, state)[0].to(torch.int8))
    return torch.stack(obs_all), torch.stack(actions_all), torch.stack(rewards_all)


def _check_weights(cfg: EnvConfig, hidden: int, w1, b1, wa, ba):
    T, S, A = cfg.max_turns, cfg.state_length, cfg.num_actions
    for name, x, shape in (("w1", w1, (T, S, hidden)), ("b1", b1, (T, hidden)),
                           ("wa", wa, (T, hidden, A)), ("ba", ba, (T, A))):
        if tuple(x.shape) != shape:
            raise ValueError(f"act_rollout: {name} has shape {tuple(x.shape)}, expected {shape}")
        if x.dtype != torch.float32:
            raise TypeError(f"act_rollout: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"act_rollout: {name} must be contiguous")
        if x.device != w1.device:
            raise ValueError("act_rollout: all weights must be on one device")


def make_act_rollout_kernel(cfg: EnvConfig, num_games: int, hidden: int):
    """Build ``play(seed, w1, b1, wa, ba)`` for ``num_games`` games (any G)."""
    if hidden > MAX_HIDDEN:
        raise ValueError(f"act_rollout kernel supports hidden <= {MAX_HIDDEN}")
    if cfg.num_cards > 127:
        raise ValueError("int8 observations need card ids below 128")
    _check_cfg(cfg)
    G, P, S = num_games, cfg.num_players, cfg.state_length
    n_turns = cfg.max_turns

    def play(seed, w1, b1, wa, ba):
        seed = _check_seed(seed)
        if w1.device.type == "cpu":
            return act_rollout_plain(cfg, seed, G, w1, b1, wa, ba)
        if w1.device.type != "cuda":
            raise ValueError(f"act_rollout: unsupported device {w1.device}")
        _check_weights(cfg, hidden, w1, b1, wa, ba)
        dev = w1.device
        obs = torch.empty((n_turns + 1, G, P, S), dtype=torch.int8, device=dev)
        actions = torch.empty((n_turns, G, P), dtype=torch.int32, device=dev)
        rewards = torch.empty((n_turns, G, P), dtype=torch.int32, device=dev)
        if G == 0:
            return obs, actions, rewards
        code = _build.library().rl6_act_rollout(
            seed, w1.data_ptr(), b1.data_ptr(), wa.data_ptr(), ba.data_ptr(),
            obs.data_ptr(), actions.data_ptr(), rewards.data_ptr(),
            G, P, cfg.num_rows, cfg.threshold, cfg.hand_size, cfg.num_cards,
            hidden, n_turns, int(cfg.include_summaries), _build.stream_ptr(dev),
        )
        _build.check(code, "act_rollout")
        _build.LAUNCHES["act_rollout"] += 1
        return obs, actions, rewards

    return play
