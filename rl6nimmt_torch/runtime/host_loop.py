"""A short host loop that plays whole games between host agents on the port's engine.

Each game is dealt by ``deal`` (K2 on the card) and every turn resolved by
``step`` (K1 on the card).  The loop keeps the reference session's step
protocol (play.py:29-72): every agent gets its own observation and legal-card
list, and ``learn`` receives the *previous* turn's reward as ``reward`` and
the fresh one as ``next_reward``, with the agent's ``forward`` extras
(``step_record``, ``log_probs``, ...) as keyword arguments.  The tournament's
game session, with its rendering and bookkeeping, is :mod:`.session`.
"""

from __future__ import annotations

import numpy as np

from ..engine import EnvConfig, deal, observe, step
from ..utils.device import resolve_device


def _view(cfg: EnvConfig, state):
    """Game 0's observations ``f32[P, S]`` and each seat's legal cards (its hand, ascending)."""
    hands = state.hands_sorted[0].cpu().numpy()
    return observe(cfg, state)[0][0].cpu().numpy(), [[int(c) for c in hand if c >= 0] for hand in hands]


def play_games(agents, num_games: int = 1, seed: int = 0, device="cuda") -> np.ndarray:
    """Play ``num_games`` games (game ``i`` dealt from Philox seed ``seed + i``)
    and return the total rewards ``int64[num_games, len(agents)]``
    (minus the penalty points)."""
    dev = resolve_device(device)
    cfg = EnvConfig(num_players=len(agents))
    results = np.zeros((num_games, len(agents)), np.int64)
    for game in range(num_games):
        state = deal(cfg, seed + game, 1, device=dev)
        obs, legal = _view(cfg, state)
        rewards = np.zeros(len(agents), np.int64)
        for turn in range(cfg.max_turns):
            picks = [agent(obs[i], legal_actions=legal[i]) for i, agent in enumerate(agents)]
            actions = [int(a) for a, _ in picks]
            state, step_rewards = step(cfg, state, state.hands_sorted.new_tensor([actions]))
            next_rewards = step_rewards[0].cpu().numpy().astype(np.int64)
            next_obs, next_legal = _view(cfg, state)
            done = turn == cfg.max_turns - 1
            for i, agent in enumerate(agents):
                agent.learn(state=obs[i], legal_actions=legal[i], reward=rewards[i], action=actions[i], done=done,
                            next_state=next_obs[i], next_legal_actions=next_legal[i], next_reward=next_rewards[i],
                            num_episode=game, episode_end=done, **picks[i][1])
            results[game] += next_rewards
            obs, legal, rewards = next_obs, next_legal, next_rewards
    return results
