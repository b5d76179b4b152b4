"""Single-game driver for heterogeneous agents (port of ``runtime/session.py``, reference play.py:9-87).

Runs the act -> ``env.step`` -> learn loop for one game between arbitrary
agents, keeping the reference's step protocol exactly:

* each agent receives its own observation and legal-card list;
* ``learn`` receives the *previous* turn's reward as ``reward`` and the fresh
  one as ``next_reward`` (the reward-lag quirk, play.py:29-72);
* agent ``forward`` extras flow back into ``learn`` as keyword arguments;
* per-game total scores accumulate into ``self.results``.

The game runs on :class:`~..engine.wrapper.SechsNimmtEnv` on ``device``: one
K2 deal a game and one K1 resolution a turn on the card.
"""

from __future__ import annotations

import logging

import numpy as np

from ..engine.wrapper import SechsNimmtEnv

logger = logging.getLogger(__name__)


class GameSession:
    def __init__(self, *agents, env_seed=None, device="cuda"):
        self.agents = list(agents)
        self.num_agents = len(agents)
        self.env = SechsNimmtEnv(self.num_agents, seed=env_seed, device=device)
        self.results = []
        self.game = 0
        self.env._player_names = [getattr(agent, "__name__", type(agent).__name__) for agent in agents]

    def play_game(self, render: bool = False) -> None:
        states, all_legal = self.env.reset()
        done = False
        rewards = np.zeros(self.num_agents, dtype=np.int64)
        scores = np.zeros(self.num_agents, dtype=np.int64)

        if render:
            self.env.render()

        while not done:
            actions, agent_infos = [], []
            for agent, state, legal in zip(self.agents, states, all_legal):
                action, info = agent(state, legal_actions=legal)
                actions.append(int(action))
                agent_infos.append(info)

            (next_states, next_all_legal), next_rewards, done, _ = self.env.step(actions)

            if render:
                self.env.render()

            for i, agent in enumerate(self.agents):
                agent.learn(
                    state=states[i],
                    legal_actions=list(all_legal[i]),
                    reward=rewards[i],
                    action=actions[i],
                    done=done,
                    next_state=next_states[i],
                    next_legal_actions=list(next_all_legal[i]),
                    next_reward=next_rewards[i],
                    num_episode=self.game,
                    episode_end=done,
                    **agent_infos[i],
                )

            scores += np.asarray(next_rewards)
            states, all_legal, rewards = next_states, next_all_legal, next_rewards

        self.results.append(scores)
        self.game += 1
