"""Block driver: many heterogeneous games in lockstep, batched search acting
(port of ``runtime/block.py``).

The reference tournament plays its games strictly one at a time (a fresh
``GameSession`` per game, tournament.py:132-138), so the search agents' playout
compute -- the dominant cost of the whole published experiment -- runs at
batch size one game.  Here a *block* of games advances turn-by-turn in
lockstep: every turn, each search agent decides its move in ALL its seated
games through :meth:`BaseMCAgent.forward_many`, which fuses every game's
determinized playouts into shared playout calls (agents/mcs.py).  Since all
games last exactly ``hand_size`` turns, lockstep needs no padding.

Protocol fidelity (vs ``GameSession``, reference play.py:23-75):

* acting uses each agent family's exact ``forward`` semantics -- search
  agents' per-game root logic is byte-for-byte the sequential path
  (``_mcts`` delegates to the same ``_mcts_many``), non-search agents are
  called per seat;
* ``learn`` receives the identical argument stream -- reward lag, agent-info
  round trip, ``num_episode=0`` per fresh session -- replayed per game in
  block order after all games finish.

The one controlled deviation (PARITY.md): learning is applied at block end
rather than interleaved with other games' turns, so an agent seated in many
games of one block acts with parameters up to one block stale.  Sequential
semantics are recovered exactly at ``block size 1``.

Every game runs on its own :class:`~..engine.wrapper.SechsNimmtEnv` on
``device``: one K2 deal a game and one K1 resolution a game turn on the card,
and every playout turn of a search agent's batched decision one more K1.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..agents.mcs import BaseMCAgent
from ..engine.wrapper import SechsNimmtEnv


class BlockSession:
    """Play ``len(lineups)`` games to completion, batching search decisions.

    ``lineups`` is a list of agent lists (2+ agents each, possibly sharing
    instances across games).  ``play()`` returns one total-score array per
    game, ordered like ``lineups``.
    """

    def __init__(self, lineups: Sequence[Sequence], env_seeds: Optional[Sequence[int]] = None, device="cuda"):
        assert lineups, "need at least one game"
        self.lineups = [list(agents) for agents in lineups]
        self.envs = [
            SechsNimmtEnv(
                len(agents),
                seed=None if env_seeds is None else env_seeds[g],
                player_names=[
                    getattr(a, "__name__", type(a).__name__) for a in agents
                ],
                device=device,
            )
            for g, agents in enumerate(self.lineups)
        ]
        self.results: List[np.ndarray] = []

    def play(self) -> List[np.ndarray]:
        G = len(self.lineups)
        resets = [env.reset() for env in self.envs]
        states = [r[0] for r in resets]
        legals = [r[1] for r in resets]
        rewards = [np.zeros(len(l), dtype=np.int64) for l in self.lineups]
        scores = [np.zeros(len(l), dtype=np.int64) for l in self.lineups]
        memories = {
            (g, i): BaseMCAgent.new_memory()
            for g, agents in enumerate(self.lineups)
            for i, a in enumerate(agents)
            if isinstance(a, BaseMCAgent) and a.batched_forward
        }
        trajectories = [[] for _ in range(G)]

        turns = self.envs[0].config.hand_size
        for _ in range(turns):
            actions = [[None] * len(l) for l in self.lineups]
            infos = [[None] * len(l) for l in self.lineups]

            # ---- act: group search seats per agent, direct-call the rest
            grouped = {}
            for g, agents in enumerate(self.lineups):
                for i, agent in enumerate(agents):
                    if (g, i) in memories:
                        grouped.setdefault(id(agent), (agent, []))[1].append((g, i))
                    else:
                        action, info = agent(states[g][i], legal_actions=legals[g][i])
                        actions[g][i] = int(action)
                        infos[g][i] = info
            for agent, seats in grouped.values():
                outs = agent.forward_many(
                    [states[g][i] for g, i in seats],
                    [legals[g][i] for g, i in seats],
                    [memories[g, i] for g, i in seats],
                )
                for (g, i), (action, info) in zip(seats, outs):
                    actions[g][i] = int(action)
                    infos[g][i] = info

            # ---- step every env; record the GameSession argument stream
            for g, env in enumerate(self.envs):
                (next_states, next_legals), next_rewards, done, _ = env.step(actions[g])
                trajectories[g].append(
                    dict(
                        states=states[g],
                        legals=[list(l) for l in legals[g]],
                        rewards=rewards[g],
                        actions=actions[g],
                        done=done,
                        next_states=next_states,
                        next_legals=[list(l) for l in next_legals],
                        next_rewards=next_rewards,
                        infos=infos[g],
                    )
                )
                scores[g] += np.asarray(next_rewards)
                states[g], legals[g], rewards[g] = next_states, next_legals, next_rewards

        # ---- learn: replay each game's full episode in block order
        for g, agents in enumerate(self.lineups):
            for rec in trajectories[g]:
                for i, agent in enumerate(agents):
                    agent.learn(
                        state=rec["states"][i],
                        legal_actions=rec["legals"][i],
                        reward=rec["rewards"][i],
                        action=rec["actions"][i],
                        done=rec["done"],
                        next_state=rec["next_states"][i],
                        next_legal_actions=rec["next_legals"][i],
                        next_reward=rec["next_rewards"][i],
                        num_episode=0,  # fresh-session parity (play.py:69)
                        episode_end=rec["done"],
                        **rec["infos"][i],
                    )

        self.results = scores
        return scores
