"""Monte-Carlo search agents: MCS, PolicyMCS, PUCT ("Alpha0.5"), PUCTCustomed (port of ``agents/mcs.py``).

* :class:`MCSAgent` -- determinized Monte-Carlo search with uniform-random
  playout policies for everyone (mcts.py:181-188).
* :class:`PolicyMCSAgent` -- playout moves sampled from a learned
  action-in-input policy net (mcts.py:191-261).
* :class:`PUCTAgent` -- "Alpha0.5": the first own move of each playout is
  chosen by PUCT ``q_hat + c_puct * pi * sqrt(N) / (1 + n)`` with min-max
  normalized q over observed outcomes (mcts.py:264-323).
* :class:`PUCTUniformAgent` -- PUCT with the net as root prior only and
  uniform playouts.
* :class:`PUCTCustomedAgent` -- playout-free variant: a single (pi, V) net
  evaluation; picks argmax-V (mcts.py:325-451).

Search state per episode: a host-side card memory (``available_cards``)
tracking which card ids have never been observed; unknown opponent hands are
re-dealt uniformly from it for each playout (mcts.py:62-73, 116-127).

As in the JAX package, the root logic of the host path (``device_root=False``)
draws from NumPy's global generator (the determinizations, MCS's and
PolicyMCS's first moves), so given the playouts' outcomes it makes the JAX
agent's choices; the playouts draw from the agent's ``torch.Generator``.
Playouts run in batches of ``batch_playouts``, with PUCT visit counts updated
inside a batch and outcome statistics between batches.  ``device_root=True``
runs the whole decision in :mod:`.device_search`.

Learning: PolicyMCS and PUCT imitate their own search choices at the end of
each episode (``-sum_t log pi(chosen_t)``, mcts.py:245-256); PUCTCustomed
adds the squared error of the chosen card's value against the episode
return (mcts.py:325-451).  One Adam step an episode, the gradient from
``torch.autograd``, as the REINFORCE agents learn.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..engine.state import EnvConfig
from ..nets import MLPSpec, mlp_init
from ..utils.ops import onehot_select
from .base import Agent, pad_cards
from .dqn import grad_leaves, optimizer_step
from .reinforce import action_in_input_heads, action_in_input_logits, episode_batch
from .search import build_root_states_batch, make_playout_fn


class BaseMCAgent(Agent):
    """Shared search scaffolding: card memory, determinization, batching."""

    playout_policy = "uniform"
    root_strategy = "uniform"
    batched_forward = True  # block driver may route through forward_many

    def __init__(
        self,
        handsize: int = 10,
        num_rows: int = 4,
        num_cards: int = 104,
        threshold: int = 6,
        mc_per_card: int = 10,
        mc_max: int = 100,
        include_summaries: bool = True,
        batch_playouts: Optional[int] = None,
        device_root: bool = False,
        *args,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.device_root = device_root
        self.handsize = handsize
        self.num_rows = num_rows
        self.num_cards = num_cards
        self.threshold = threshold
        self.mc_per_card = mc_per_card
        self.mc_max = mc_max
        self.include_summaries = include_summaries
        self.batch_playouts = batch_playouts
        self.num_players: Optional[int] = None
        self.available_cards: List[int] = []

    # ------------------------------------------------------------ interface

    def forward(self, state, legal_actions, *args, **kwargs):
        state = np.asarray(state, np.float32)
        n = len(legal_actions)
        if n == self.handsize:
            self._initialize_game(state)
        self._memorize_cards(state, legal_actions)

        if n == 1:
            return legal_actions[0], {"log_prob": 0.0, "step_record": self._record(state, legal_actions, 0)}
        return self._mcts(legal_actions, state)

    def forward_many(self, states, legal_lists, memories):
        """Batched forward across concurrent games (the block driver's path).

        One call decides this agent's move in many simultaneous games:
        per-game card memory lives in the caller-threaded ``memories`` dicts
        (:meth:`new_memory`), and every playout round batches all games'
        determinized playouts into one playout call.  Root semantics per game
        are those of :meth:`forward`.
        """
        results: List[Optional[tuple]] = [None] * len(states)
        groups = {}
        for i, (state, legal, mem) in enumerate(zip(states, legal_lists, memories)):
            state = np.asarray(state, np.float32)
            # Bind this game's memory to the instance attrs the single-game
            # helpers use (the host path is single-threaded), then write back.
            self.available_cards = mem["available_cards"]
            self.num_players = mem["num_players"]
            n = len(legal)
            if n == self.handsize:
                self._initialize_game(state)
            self._memorize_cards(state, legal)
            mem["available_cards"] = self.available_cards
            mem["num_players"] = self.num_players
            if n == 1:
                results[i] = (legal[0], {"log_prob": 0.0, "step_record": self._record(state, legal, 0)})
            else:
                groups.setdefault((mem["num_players"], n), []).append((i, state, legal, mem))
        for (num_players, n), group in groups.items():
            for i, result in zip([g[0] for g in group], self._mcts_many(num_players, n, group)):
                results[i] = result
        return results

    @staticmethod
    def new_memory() -> dict:
        """Fresh per-(game, seat) card memory for :meth:`forward_many`."""
        return {"available_cards": [], "num_players": None}

    # ---------------------------------------------------------- card memory

    def _initialize_game(self, state) -> None:
        self.available_cards = list(range(self.num_cards))
        self.num_players = int(state[10])

    def _memorize_cards(self, state, legal_actions) -> None:
        for card in list(legal_actions) + self._board_from_state(state, flatten=True):
            if card >= 0 and card in self.available_cards:
                self.available_cards.remove(card)

    def _board_from_state(self, state, flatten: bool = True):
        grid = np.asarray(state)[-self.num_rows * self.threshold:].reshape(self.num_rows, self.threshold)
        rows = [[int(c) for c in row if c >= 0] for row in grid]
        return [c for row in rows for c in row] if flatten else rows

    # --------------------------------------------------------------- search

    def _mcts(self, legal_actions, state):
        """Single-game search = the cross-game path with one request."""
        mem = {"available_cards": self.available_cards, "num_players": self.num_players}
        group = [(0, np.asarray(state, np.float32), legal_actions, mem)]
        return self._mcts_many(self.num_players, len(legal_actions), group)[0]

    def _mcts_many(self, num_players: int, n: int, group):
        """Cross-game search: one playout call per round for all games.

        ``group`` is a list of ``(idx, state, legal_actions, memory)`` tuples
        sharing player count and hand size.  Per game the root logic -- round
        structure, first-move choice, outcome bookkeeping -- is the
        single-game search; only the playouts run together.
        """
        G = len(group)
        n_mc = self._compute_n_mc(n)
        env_cfg = EnvConfig(num_players=num_players, num_rows=self.num_rows, num_cards=self.num_cards,
                            threshold=self.threshold, include_summaries=self.include_summaries)
        if self.device_root:
            return self._mcts_many_device(env_cfg, n, n_mc, group)
        playout = make_playout_fn(env_cfg, self.playout_policy, self._playout_spec(), self.device)
        boards = [self._board_from_state(state, flatten=False) for _, state, _, _ in group]
        my_hands = [list(legal) for _, _, legal, _ in group]
        outcomes = [{a: [] for a in legal} for _, _, legal, _ in group]
        rlps = [self._root_log_probs(state, legal) for _, state, legal, _ in group]

        remaining = n_mc
        batch = self.batch_playouts or n_mc
        while remaining > 0:
            K = min(batch, remaining)
            firsts = np.stack([self._choose_first_moves(K, group[g][2], outcomes[g], rlps[g])
                               for g in range(G)])  # [G, K]
            opp = np.stack([self._deal_opponent_hands(K, n, pool=group[g][3]["available_cards"],
                                                      num_players=num_players)
                            for g in range(G)])  # [G, K, P-1, n]
            states0 = build_root_states_batch(env_cfg, boards, my_hands, opp, self.device)
            rets = self._run_playout_batch(playout, states0, firsts.reshape(-1), n).reshape(G, K)
            for g in range(G):
                for a, r in zip(firsts[g], rets[g]):
                    outcomes[g][int(a)].append(float(r))
            remaining -= K

        results = []
        for g, (_, state, legal, _) in enumerate(group):
            action, info = self._choose_action_from_outcomes(outcomes[g], rlps[g])
            idx = list(legal).index(action)
            info["step_record"] = self._record(state, legal, idx)
            results.append((action, info))
        return results

    def _mcts_many_device(self, env_cfg: EnvConfig, n: int, n_mc: int, group):
        """One decision call decides every game of the group (``device_root``).

        The whole decision -- determinization, root selection, playout
        rounds, outcome aggregation -- runs in :mod:`.device_search` on the
        agent's device with noise from the agent's generator.
        """
        from .device_search import make_device_decision_fn_many

        if getattr(self, "temperature", None) is not None and self.temperature > 1e-12:
            raise NotImplementedError("visit-count temperature sampling (parity: mcts.py:318-323)")
        G = len(group)
        R, T, C, H = self.num_rows, self.threshold, self.num_cards, self.handsize
        boards = np.full((G, R, T), -1, np.int32)
        row_lens = np.zeros((G, R), np.int32)
        hands = np.full((G, H), -1, np.int32)
        avails = np.zeros((G, C), bool)
        obses = np.zeros((G, env_cfg.state_length), np.float32)
        for g, (_, state, legal, mem) in enumerate(group):
            for r, cards in enumerate(self._board_from_state(state, flatten=False)):
                boards[g, r, : len(cards)] = cards
                row_lens[g, r] = len(cards)
            hands[g, :n] = sorted(legal)
            avails[g, mem["available_cards"]] = True
            obses[g] = state

        fn = make_device_decision_fn_many(
            env_cfg, self.playout_policy, self._playout_spec(), self.root_strategy, self.mc_max,
            self.batch_playouts or self.mc_max, float(getattr(self, "c_puct", 0.0)), self.device)
        put = lambda x: torch.from_numpy(x).to(self.device)
        actions, logps = fn(self._playout_params(), put(boards), put(row_lens), put(hands), n, n_mc,
                            put(avails), put(obses), self.generator)
        actions, logps = actions.cpu().numpy(), logps.cpu().numpy()

        results = []
        for g, (_, state, legal, _) in enumerate(group):
            action = int(actions[g])
            idx = list(legal).index(action)
            results.append((action, {"log_prob": float(logps[g]), "step_record": self._record(state, legal, idx)}))
        return results

    def _run_playout_batch(self, playout, states0, first, n) -> np.ndarray:
        """Player 0's returns ``f32[B]`` of the B playouts, in one call."""
        first = torch.from_numpy(np.asarray(first, np.int64)).to(self.device)
        return playout(self._playout_params(), states0, first, n, self.generator).cpu().numpy()

    def _compute_n_mc(self, n_actions: int) -> int:
        return min(self.mc_max, self.mc_per_card * math.factorial(n_actions))

    def _deal_opponent_hands(self, K: int, n: int, pool=None, num_players=None) -> np.ndarray:
        """K determinizations: (P-1) sorted hands of n unseen cards each."""
        pool = np.asarray(self.available_cards if pool is None else pool, dtype=np.int64)
        P = self.num_players if num_players is None else num_players
        perms = np.argsort(np.random.random((K, pool.shape[0])), axis=1)
        need = (P - 1) * n
        picked = pool[perms[:, :need]].reshape(K, P - 1, n)
        return np.sort(picked, axis=2)

    def _choose_action_from_outcomes(self, outcomes, root_log_probs):
        best_action = next(iter(outcomes))
        best_mean = -float("inf")
        for action, rets in outcomes.items():
            mean = np.mean(rets) if rets else float("nan")
            if mean > best_mean:
                best_action, best_mean = action, mean
        return best_action, {"log_prob": float(root_log_probs[best_action])}

    # -------------------------------------------------------- variant hooks

    def _playout_spec(self):
        return None

    def _playout_params(self):
        return None

    def _root_log_probs(self, state, legal_actions):
        return {a: 0.0 for a in legal_actions}

    def _choose_first_moves(self, K, legal_actions, outcomes, root_log_probs):
        raise NotImplementedError

    def _record(self, state, legal_actions, chosen_idx):
        return {
            "state": np.asarray(state, np.float32),
            "legal_cards": pad_cards(legal_actions, self.handsize),
            "chosen": np.int32(chosen_idx),
        }


class MCSAgent(BaseMCAgent):
    """Uniform-random playouts for everyone; no learning (mcts.py:181-188)."""

    def _choose_first_moves(self, K, legal_actions, outcomes, root_log_probs):
        return np.random.choice(np.asarray(legal_actions, np.int64), size=K)

    def learn(self, *args, **kwargs):
        return None


class PolicyMCSAgent(BaseMCAgent):
    """Learned playout policy; learns by self-imitation (mcts.py:191-261)."""

    playout_policy = "net"
    root_strategy = "policy"

    def __init__(self, hidden_sizes: Tuple[int, ...] = (100, 100), r_factor: float = 0.1, **kwargs):
        super().__init__(**kwargs)
        self.r_factor = r_factor
        self.spec = MLPSpec(input_size=self.state_length + 1, hidden_sizes=tuple(hidden_sizes), head_sizes=(1,))
        self.params = mlp_init(self.generator, self.spec, self.device)
        self._episode = []

    def parameters(self):
        return self.params

    def set_parameters(self, params) -> None:
        self.params = params

    def _playout_spec(self):
        return self.spec

    def _playout_params(self):
        return self.params

    def _root_log_probs(self, state, legal_actions):
        padded = torch.from_numpy(pad_cards(legal_actions, self.handsize)).to(self.device)
        logits = action_in_input_logits(self.spec, self.params, torch.from_numpy(state).to(self.device), padded)
        logp = torch.log_softmax(logits, dim=-1).cpu().numpy()
        return {a: float(logp[i]) for i, a in enumerate(legal_actions)}

    def _choose_first_moves(self, K, legal_actions, outcomes, root_log_probs):
        probs = np.exp([root_log_probs[a] for a in legal_actions])
        probs = probs / probs.sum()
        return np.random.choice(np.asarray(legal_actions, np.int64), size=K, p=probs)

    # ----------------------------------------------------------------- learn

    def learn(
        self, state, reward, action, done, next_state, next_reward, episode_end, num_episode,
        legal_actions=None, **kwargs,
    ):
        batch = episode_batch(self, kwargs["step_record"], reward, episode_end)
        if batch is None:
            return 0.0
        leaves, live = grad_leaves(self.params)
        loss = self._loss(live, batch)
        self.params, self.opt_state = optimizer_step(self.optimizer, self.params, self.opt_state, loss, leaves)
        return float(loss.detach())

    def _loss(self, params, batch):
        """Imitate the episode's own search choices (mcts.py:245-256)."""
        logits = action_in_input_logits(self.spec, params, batch["state"], batch["legal_cards"])
        return -torch.sum(onehot_select(torch.log_softmax(logits, dim=-1), batch["chosen"]))


class PUCTAgent(PolicyMCSAgent):
    """Alpha0.5: PUCT root selection over determinized playouts (mcts.py:264-323)."""

    root_strategy = "puct"

    def __init__(self, c_puct: float = 2.0, temperature: Optional[float] = None, **kwargs):
        kwargs.setdefault("batch_playouts", 8)
        super().__init__(**kwargs)
        self.c_puct = c_puct
        self.temperature = temperature

    def _choose_first_moves(self, K, legal_actions, outcomes, root_log_probs):
        """Sequential PUCT with intra-batch pending visit counts."""
        probs = np.exp([root_log_probs[a] for a in legal_actions])
        counts = np.asarray([len(outcomes[a]) for a in legal_actions], dtype=np.float64)
        chosen = []
        for _ in range(K):
            pucts = self._compute_pucts(legal_actions, outcomes, probs, counts)
            pick = int(np.argmax(pucts))
            chosen.append(int(legal_actions[pick]))
            counts[pick] += 1
        return np.asarray(chosen, dtype=np.int64)

    def _compute_pucts(self, legal_actions, outcomes, probs, counts):
        n_total = counts.sum()
        max_r, min_r, mid_r = self._normalize_q(outcomes)
        q = np.asarray([np.mean(outcomes[a]) if outcomes[a] else mid_r for a in legal_actions])
        if max_r == min_r:
            # All observed outcomes equal: the reference's (q-min)/(max-min)
            # is 0/0 and its argmax degenerates to index 0 (mcts.py:276-302);
            # as in the JAX package, treat all moves as mid-value so
            # exploration falls to the prior term.
            q = np.full_like(q, 0.5)
        else:
            q = np.clip((q - min_r) / (max_r - min_r), 0.0, 1.0)
        return q + self.c_puct * probs * (n_total + 1e-9) ** 0.5 / (1.0 + counts)

    @staticmethod
    def _normalize_q(outcomes):
        rets = [r for rs in outcomes.values() for r in rs]
        if len(rets) < 10:
            return 0.0, -10.0, -5.0  # cold-start constants (mcts.py:304-315)
        return float(np.max(rets)), float(np.min(rets)), float(np.median(rets))

    def _choose_action_from_outcomes(self, outcomes, root_log_probs):
        if self.temperature is None or self.temperature <= 1e-12:
            return super()._choose_action_from_outcomes(outcomes, root_log_probs)
        raise NotImplementedError("visit-count temperature sampling (parity: mcts.py:318-323)")


class PUCTUniformAgent(PUCTAgent):
    """Decoupled Alpha0.5: the net drives the PUCT ROOT prior only; the
    determinized playouts stay uniform (no reference analog).  Root
    semantics and the device decision path are :class:`PUCTAgent`'s; only the
    playout policy differs."""

    playout_policy = "uniform"


class PUCTCustomedAgent(PUCTAgent):
    """Playout-free PUCT variant with a (pi, V) net (mcts.py:325-451)."""

    # No playouts to batch: decisions are one small (pi, V) forward each, so
    # the block driver calls plain forward per game.
    batched_forward = False

    def __init__(self, hidden_sizes: Tuple[int, ...] = (100, 100), **kwargs):
        super().__init__(hidden_sizes=hidden_sizes, **kwargs)
        # Single head of width 2: column 0 = policy logit, column 1 = value.
        self.spec = MLPSpec(input_size=self.state_length + 1, hidden_sizes=tuple(hidden_sizes), head_sizes=(2,))
        self.params = mlp_init(self.generator, self.spec, self.device)

    def forward(self, state, legal_actions, *args, **kwargs):
        state = np.asarray(state, np.float32)
        n = len(legal_actions)
        if n == self.handsize:
            self._initialize_game(state)
        self._memorize_cards(state, legal_actions)

        action, info = self._nn_choice(state, legal_actions)
        if n == 1:
            idx = 0
            action = legal_actions[0]
            info = {"log_prob": 0.0, "outcome": info["outcome"]}
        else:
            idx = list(legal_actions).index(action)
        info["step_record"] = self._record(state, legal_actions, idx)
        return action, info

    def _nn_choice(self, state, legal_actions):
        padded = torch.from_numpy(pad_cards(legal_actions, self.handsize)).to(self.device)
        logp, values = _policy_value(self.spec, self.params, torch.from_numpy(state).to(self.device), padded)
        logp, values = logp.cpu().numpy(), values.cpu().numpy()[: len(legal_actions)]
        idx = int(np.argmax(values))
        return int(legal_actions[idx]), {"log_prob": float(logp[idx]), "outcome": float(values[idx])}

    def _loss(self, params, batch):
        """The chosen card's value against the episode return, plus self-imitation."""
        logp, values = _policy_value(self.spec, params, batch["state"], batch["legal_cards"])
        chosen = batch["chosen"]
        reward_sum = torch.sum(batch["reward"]) / self.r_factor
        outcome_loss = torch.mean((onehot_select(values, chosen) - reward_sum) ** 2)
        return outcome_loss - torch.sum(onehot_select(logp, chosen))


def _policy_value(spec: MLPSpec, params, state, legal_cards):
    """(log pi over legal slots, V per slot) from the width-2 head; batched over leading axes."""
    (out,) = action_in_input_heads(spec, params, state, legal_cards)
    valid = legal_cards >= 0
    logits = torch.where(valid, out[..., 0], -torch.inf)
    return torch.log_softmax(logits, dim=-1), torch.where(valid, out[..., 1], -torch.inf)
