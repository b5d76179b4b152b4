"""ACER: actor-critic with experience replay (port of ``agents/acer.py``).

* :func:`actor_critic_heads` -- the action-in-input actor-critic: rows
  ``[action | state]`` through a shared 2-head MLP giving a policy logit and
  Q per legal card; log-probs over the legal slots, padded slots
  ``LOG_EPSILON`` / 0 (reference actor_critic.py:85-96).
* :func:`acer_qret` -- the retrace recursion per sequence, masked by length.
* :func:`make_acer_train_step` -- truncated importance sampling with bias
  correction, the retrace target and a Huber critic, each sequence's mean
  weighted by its step count (the reference's flattened-stream mean);
  ``packed_rows=True`` runs each step's heads on its live rows only.
* :class:`BatchedActionValueActorCriticAgent` and :class:`BatchedACERAgent`
  -- the host agents: sequences of up to ``rollout_len`` steps are flushed
  into a :class:`~..buffers.host.HostSequentialHistory`; each flush past the
  warmup runs one on-policy update (the latest sequence) and one off-policy
  update (a uniform minibatch of sequences).

``jax.lax.stop_gradient`` is ``.detach()`` at the same places.  As in the
reference, ACER stores the *current* step's reward (``next_reward *
r_factor``), not the lagged one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..buffers.host import HostSequentialHistory
from ..nets import MLPSpec, mlp_init
from ..utils.ops import onehot_select
from .base import Agent, pad_cards
from .dqn import grad_leaves, optimizer_step
from .reinforce import action_in_input_heads, sample_index

LOG_EPSILON = -20.0


# ---------------------------------------------------------------- pure math


def actor_critic_heads(spec: MLPSpec, params, state, legal_cards):
    """Padded ``(log_probs[..., H], qs[..., H])`` for states ``[..., S]`` and
    -1-padded legal sets ``[..., H]``: softmax over the legal rows only,
    padded slots ``LOG_EPSILON`` / 0."""
    logits, qs = action_in_input_heads(spec, params, state, legal_cards)
    valid = legal_cards >= 0
    log_probs = torch.log_softmax(torch.where(valid, logits[..., 0], -torch.inf), dim=-1)
    log_probs = torch.where(valid, torch.clamp(log_probs, min=LOG_EPSILON), LOG_EPSILON)
    return log_probs, torch.where(valid, qs[..., 0], 0.0)


def acer_qret(rewards, dones, q_a, v, rho_bar, length, gamma: float):
    """The retrace targets of padded sequences: every input ``[..., T]``,
    ``length [...]``; returns ``[..., T]`` (0 past each length).

    Each sequence bootstraps from its own last step's ``v * (1 - done)``;
    equivalent to the reference's flattened reverse loop with ``first``-flag
    re-initialization (actor_critic.py:195-207).
    """
    T = rewards.shape[-1]
    q_ret = torch.zeros_like(rewards[..., 0])
    out = torch.zeros_like(rewards)
    for t in range(T - 1, -1, -1):
        is_last = length == t + 1
        valid = length > t
        q_in = torch.where(is_last, v[..., t] * (1.0 - dones[..., t]), q_ret)
        q_now = rewards[..., t] + gamma * q_in
        q_next = rho_bar[..., t] * (q_now - q_a[..., t]) + v[..., t]
        q_ret = torch.where(valid, q_next, q_ret)
        out[..., t] = torch.where(valid, q_now, 0.0)
    return out


def packed_heads(spec: MLPSpec, params, state, legal_cards):
    """:func:`actor_critic_heads` of full aligned episodes ``[B, T, ...]``
    (step t's cards in the leading ``H - t`` slots), each step's forward on
    its live rows only; the padded slots get ``LOG_EPSILON`` / 0 as before."""
    B, T, H = legal_cards.shape
    lps, qs = [], []
    for t in range(T):
        lp, q = actor_critic_heads(spec, params, state[:, t], legal_cards[:, t, : H - t])
        if t:
            lp = torch.cat([lp, lp.new_full((B, t), LOG_EPSILON)], dim=1)
            q = torch.cat([q, q.new_zeros((B, t))], dim=1)
        lps.append(lp)
        qs.append(q)
    return torch.stack(lps, dim=1), torch.stack(qs, dim=1)


def acer_losses(log_probs_now, q, batch, gamma: float, truncate: float, critic_weight: float):
    """``(actor, correction, critic)`` of a ``[B, T]`` batch from its heads ``[B, T, H]``:
    per sequence the mean over its valid steps, then the sequences' means
    weighted by their step counts."""
    T = q.shape[1]
    aid = batch["action_id"]
    behavior = batch["log_probs"]
    q_a = onehot_select(q, aid)                                              # [B, T]
    logp_now_a = onehot_select(log_probs_now, aid)
    v = torch.sum(q * torch.exp(log_probs_now), dim=2).detach()
    rho = torch.exp(log_probs_now - behavior).detach()
    rho_bar = torch.clamp(onehot_select(rho, aid), max=truncate)
    correction_coeff = torch.clamp(1.0 - truncate / rho, min=0.0)
    q_ret = acer_qret(batch["reward"], batch["done"], q_a.detach(), v, rho_bar, batch["length"], gamma).detach()

    actor_terms = -rho_bar * logp_now_a * (q_ret - v)
    correction_terms = torch.sum(
        -correction_coeff * torch.exp(behavior) * log_probs_now * (q.detach() - v[:, :, None]), dim=2)
    diff = q_a - q_ret
    huber = torch.where(torch.abs(diff) < 1.0, 0.5 * diff ** 2, torch.abs(diff) - 0.5)

    m = (torch.arange(T, device=q.device)[None, :] < batch["length"][:, None]).to(torch.float32)
    n = torch.clamp(m.sum(dim=1), min=1.0)                                   # [B]
    w = n / n.sum()
    al = torch.sum(torch.sum(actor_terms * m, dim=1) / n * w)
    cl = torch.sum(torch.sum(correction_terms * m, dim=1) / n * w)
    crl = torch.sum(critic_weight * torch.sum(huber * m, dim=1) / n * w)
    return al, cl, crl


def make_acer_train_step(
    spec: MLPSpec,
    optimizer,
    gamma: float = 0.99,
    truncate: float = 1.0,
    actor_weight: float = 1.0,
    critic_weight: float = 1.0,
    packed_rows: bool = False,
    axis_name=None,
):
    """ACER update over a batch of padded sequences (shared by the host agent
    and the vectorized self-play trainer).

    ``train(params, opt_state, batch) -> (params, opt_state, (actor,
    correction, critic))``; ``batch`` holds ``[B, T, ...]`` tensors state,
    legal_cards, log_probs (behavior), action_id, reward, done, plus
    ``length [B]``.  ``packed_rows=True`` assumes every sequence is a full
    aligned episode (step t holds exactly ``H - t`` live cards in the leading
    slots, always true of the self-play rollouts) and runs each step's heads on
    those rows only; the loss equals the default's to float round-off.
    ``axis_name`` (data parallel) is ROADMAP queue 1 item 11.
    """
    if axis_name is not None:
        raise NotImplementedError("axis_name: ROADMAP queue 1 item 11 (data parallel)")
    heads = packed_heads if packed_rows else actor_critic_heads

    def train(params, opt_state, batch):
        leaves, live = grad_leaves(params)
        log_probs_now, q = heads(spec, live, batch["state"], batch["legal_cards"])
        al, cl, crl = acer_losses(log_probs_now, q, batch, gamma, truncate, critic_weight)
        params, opt_state = optimizer_step(optimizer, params, opt_state, actor_weight * al + cl + crl, leaves)
        return params, opt_state, (al.detach(), cl.detach(), crl.detach())

    return train


# --------------------------------------------------------------- host agents


class BatchedActionValueActorCriticAgent(Agent):
    """Action-in-input actor-critic base (no training algorithm itself)."""

    def __init__(
        self,
        env=None,
        gamma: float = 0.99,
        optim_kwargs=None,
        history_length=None,
        hidden_sizes: Tuple[int, ...] = (100, 100),
        max_num_actions: int = 10,
        log_epsilon: float = LOG_EPSILON,
        seed: Optional[int] = None,
        device="cuda",
        **kwargs,
    ):
        super().__init__(env, gamma, optim_kwargs, history_length, seed=seed, device=device)
        self.max_num_actions = max_num_actions
        self.log_epsilon = log_epsilon
        self.spec = MLPSpec(input_size=1 + self.state_length, hidden_sizes=tuple(hidden_sizes), head_sizes=(1, 1))
        self.params = mlp_init(self.generator, self.spec, self.device)

    def parameters(self):
        return self.params

    def set_parameters(self, params) -> None:
        self.params = params

    def _pad_cards(self, legal_actions) -> np.ndarray:
        return pad_cards(legal_actions, self.max_num_actions)

    @torch.no_grad()
    def forward(self, state, legal_actions, **kwargs):
        state = np.asarray(state, np.float32)
        padded = self._pad_cards(legal_actions)
        cards = self._tensor(padded)
        log_probs, qs = actor_critic_heads(self.spec, self.params, self._tensor(state), cards)
        # Sample over the legal slots only.
        action_id = sample_index(torch.where(cards >= 0, log_probs, -torch.inf), self.generator)
        log_probs, qs = log_probs.cpu().numpy(), qs.cpu().numpy()
        info = {
            "action_id": action_id,
            "log_probs": log_probs,
            "log_prob": float(log_probs[action_id]),
            "values": qs,
            "value": float(qs[action_id]),
        }
        return int(legal_actions[action_id]), info

    @torch.no_grad()
    def evaluate(self, states, legal_actions_list):
        """Padded ``(log_probs[B, H], qs[B, H])`` for a batch of decision points."""
        states = np.stack([np.asarray(s, np.float32) for s in states])
        cards = np.stack([self._pad_cards(la) for la in legal_actions_list])
        return actor_critic_heads(self.spec, self.params, self._tensor(states), self._tensor(cards))

    def learn(self, *args, **kwargs):
        raise NotImplementedError


class BatchedACERAgent(BatchedActionValueActorCriticAgent):
    """ACER with truncated IS + bias correction (reference a-c.py:119-207)."""

    FIELDS = ("state", "legal_cards", "log_probs", "action_id", "reward", "done")

    def __init__(
        self,
        *args,
        rollout_len: int = 10,
        minibatch: int = 5,
        truncate: float = 1.0,
        warmup: int = 100,
        r_factor: float = 0.1,
        actor_weight: float = 1.0,
        critic_weight: float = 1.0,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.rollout_len = rollout_len
        self.batchsize = minibatch
        self.truncate = truncate
        self.warmup = warmup
        self.r_factor = r_factor
        self.actor_weight = actor_weight
        self.critic_weight = critic_weight
        self.history = HostSequentialHistory(max_length=self.history_length)

    def learn(
        self, state, reward, action, done, next_state, next_reward, episode_end, num_episode,
        legal_actions=None, **kwargs,
    ):
        # Store per step; flush each rollout_len steps or at done/episode_end;
        # past the warmup run one on- and one off-policy update.
        self.history.store(
            state=np.asarray(state, np.float32),
            legal_cards=self._pad_cards(legal_actions),
            log_probs=np.asarray(kwargs["log_probs"], np.float32),
            action_id=np.int32(kwargs["action_id"]),
            reward=np.float32(next_reward * self.r_factor),
            done=np.float32(done),
        )
        losses = None
        if self.history.current_sequence_length() >= self.rollout_len or done or episode_end:
            self.history.flush()
            if len(self.history) > max(self.warmup, self.batchsize) and self.training:
                on = self._train(on_policy=True)
                off = self._train(on_policy=False)
                losses = (on, off)
        return losses

    def _padded_batch(self, raw):
        """Sequence records (lists of per-step values) -> a fixed ``[B, T]``
        batch; shorter sequences (episode-end flushes) zero-pad and carry
        their true ``length``."""
        T = self.rollout_len
        stacked = {k: [] for k in self.FIELDS}
        lengths = []
        for b in range(len(raw["state"])):
            length = len(raw["state"][b])
            lengths.append(length)
            for k in self.FIELDS:
                v = np.stack([np.asarray(x) for x in raw[k][b]])
                if length < T:
                    v = np.concatenate([v, np.zeros((T - length,) + v.shape[1:], v.dtype)])
                stacked[k].append(v)
        batch = {k: np.stack(v) for k, v in stacked.items()}
        batch["length"] = np.asarray(lengths, np.int32)
        return batch

    def _train(self, on_policy: bool):
        if on_policy:
            raw = self.history.rollout(n=1)
        else:
            _, _, raw = self.history.sample(self.batchsize)
        batch = {k: self._tensor(v) for k, v in self._padded_batch(raw).items()}
        train = make_acer_train_step(self.spec, self.optimizer, self.gamma, self.truncate, self.actor_weight,
                                     self.critic_weight)
        self.params, self.opt_state, losses = train(self.params, self.opt_state, batch)
        return tuple(float(x) for x in losses)
