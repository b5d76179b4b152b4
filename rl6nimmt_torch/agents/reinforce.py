"""REINFORCE: the policy nets, the episode loss and the host agents (port of ``agents/reinforce.py``).

The net functions take any leading batch axes (the JAX functions took one
state and were vmapped), so one call serves every seat of every playout:

* :func:`masked_policy_logits` -- a 104-logit head masked to the legal cards;
* :func:`action_in_input_logits` / :func:`action_in_input_heads` -- the
  "action-in-input" net: one row ``[action | state]`` per candidate card
  through a 1-logit (or wider) head;
* :func:`log_probs_and_entropy`.

:func:`reinforce_loss` is the episode loss ``-sum_t gamma^t G_t log pi(a_t)``
plus ``-entropy_weight * sum_t H_t`` on log-probs recomputed under the
current parameters.  The two host agents share it:
:class:`MaskedReinforceAgent` (the masked 104-logit head) and
:class:`BatchedReinforceAgent` (action-in-input, the registry's
``"reinforce"``).  Each stores one record per step (state, legal set, chosen
index, the lagged reward times ``r_factor``) and takes one Adam step at the
end of every episode, the gradient from ``torch.autograd``.  Actions are
sampled as ``argmax(logits + Gumbel)`` from the agent's generator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..nets import MLPSpec, linear_apply, mlp_apply, mlp_init, normalize_state
from ..nets.mlp import _activation, _mm
from ..utils.ops import onehot_select
from ..utils.returns import discounted_returns
from .base import Agent, pad_cards
from .dqn import grad_leaves, optimizer_step

NEG_INF = -1e9
CARDS = 104  # the action feature's range, as normalize_state's default


def masked_policy_logits(spec: MLPSpec, params, state, legal_mask):
    """Logits over all cards with illegal entries at ``NEG_INF`` (masked variant)."""
    (logits,) = mlp_apply(spec, params, normalize_state(state))
    return torch.where(legal_mask, logits, NEG_INF)


def action_in_input_logits(spec: MLPSpec, params, state, legal_cards):
    """One logit per candidate row ``[action | state]``: ``f32[..., H]``.

    ``state`` is ``f32[..., S]`` and ``legal_cards`` ``int[..., H]`` padded with
    -1; padded rows get ``NEG_INF``.
    """
    heads = action_in_input_heads(spec, params, state, legal_cards)
    return torch.where(legal_cards >= 0, heads[0][..., 0], NEG_INF)


def action_in_input_heads(spec: MLPSpec, params, state, legal_cards):
    """All head outputs for the ``[action | state]`` candidates: ``f32[..., H, head]`` each.

    The candidate rows share the state and differ only in the leading action
    feature, and the first layer is linear, so its state part is computed once
    and the action part is a rank-1 add (exact, as in the JAX function):

        h1[h] = act(norm(state) @ W1[1:] + b1 + norm(a_h) * W1[0])

    Layers past the first run on the ``[..., H, hidden]`` batch.  With
    ``spec.compute_dtype="bfloat16"`` the shared product and every later layer
    take bfloat16 inputs; the rank-1 action term stays float32, as in JAX.
    """
    act = _activation(spec.activation)
    state_norm = normalize_state(state)                                   # [..., S]
    # The action feature's normalization: the first block of the action=True layout.
    a_norm = -1.0 + 2.0 * legal_cards.to(torch.float32) / (CARDS - 1)      # [..., H]
    first = params["trunk"][0]
    w, b = first["w"], first["b"]                                          # [1+S, D], [D]
    dtype = spec.compute_dtype
    shared = _mm(state_norm, w[1:], dtype) + b                             # [..., D]
    h = act(shared[..., None, :] + a_norm[..., :, None] * w[0])            # [..., H, D]
    for layer in params["trunk"][1:]:
        h = act(linear_apply(layer, h, dtype))
    return tuple(linear_apply(head, h, dtype) for head in params["heads"])


def log_probs_and_entropy(logits):
    """``(log_softmax(logits), entropy)`` over the last axis."""
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    entropy = -torch.sum(torch.where(p > 0, p * logp, 0.0), dim=-1)
    return logp, entropy


# ------------------------------------------------------------------- episodes


def reinforce_loss(per_step_logits_fn, params, batch, gamma: float, actor_weight: float,
                   entropy_weight: float):
    """Episode REINFORCE loss from recomputed log-probs: ``(loss, (actor, entropy))``.

    ``batch`` carries per-step tensors with leading time axis T; ``chosen`` is
    the index into the logit vector (card id for the masked variant, hand slot
    for the action-in-input one).
    """
    logits = per_step_logits_fn(params, batch)                       # [T, A]
    logp, entropy = log_probs_and_entropy(logits)
    t = torch.arange(logp.shape[0], dtype=torch.float32, device=logp.device)
    chosen_logp = onehot_select(logp, batch["chosen"])
    returns = discounted_returns(batch["reward"], gamma)
    actor_loss = -torch.sum(torch.pow(gamma, t) * returns * chosen_logp)
    entropy_loss = -torch.sum(entropy)
    return actor_weight * actor_loss + entropy_weight * entropy_loss, (actor_loss, entropy_loss)


def sample_index(logits: torch.Tensor, generator: torch.Generator) -> int:
    """One draw of ``categorical(logits)`` as ``argmax(logits + Gumbel)``."""
    from .search import draw_gumbel

    return int(torch.argmax(logits + draw_gumbel(generator, logits.shape, logits.device)))


def episode_batch(agent: Agent, step_record: dict, reward, episode_end: bool):
    """Record one step in ``agent._episode`` (its lagged reward times
    ``agent.r_factor``).  At the end of an episode in training mode return the
    episode as a batch of ``[T, ...]`` tensors on the agent's device and start
    a new one; otherwise None (an episode that ends in eval mode is dropped)."""
    agent._episode.append({**step_record, "reward": np.float32(reward * agent.r_factor)})
    if not episode_end or not agent.training:
        if episode_end:
            agent._episode = []  # eval mode: never accumulate across games
        return None
    episode, agent._episode = agent._episode, []
    return {k: agent._tensor(np.stack([rec[k] for rec in episode])) for k in episode[0]}


class _ReinforceBase(Agent):
    """Shared forward/learn scaffolding for both REINFORCE variants."""

    aux_key = ""   # the batch field the subclass's logits read beside the state

    def __init__(
        self,
        env=None,
        gamma: float = 0.99,
        optim_kwargs=None,
        history_length=None,
        hidden_sizes: Tuple[int, ...] = (100, 100),
        r_factor: float = 1.0,
        actor_weight: float = 1.0,
        entropy_weight: float = 0.0,
        seed: Optional[int] = None,
        device="cuda",
        **kwargs,
    ):
        super().__init__(env, gamma, optim_kwargs, history_length, seed=seed, device=device)
        self.r_factor = r_factor
        self.actor_weight = actor_weight
        self.entropy_weight = entropy_weight
        self.spec = self._build_spec(tuple(hidden_sizes))
        self.params = mlp_init(self.generator, self.spec, self.device)
        self._episode = []

    # -- subclass hooks

    def _build_spec(self, hidden_sizes) -> MLPSpec:
        raise NotImplementedError

    def _logits(self, params, state, aux):
        raise NotImplementedError

    def parameters(self):
        return self.params

    def set_parameters(self, params) -> None:
        self.params = params

    # -- protocol

    def learn(
        self, state, reward, action, done, next_state, next_reward, episode_end, num_episode,
        legal_actions=None, **kwargs,
    ):
        batch = episode_batch(self, kwargs["step_record"], reward, episode_end)
        if batch is None:
            return np.zeros(3)
        actor_loss, entropy_loss = self._train_step(batch)
        return np.asarray([float(actor_loss), 0.0, float(entropy_loss)])

    def _train_step(self, batch):
        """One Adam step on the episode ``batch``; returns the two loss terms."""
        leaves, live = grad_leaves(self.params)
        loss, (actor_loss, entropy_loss) = reinforce_loss(
            lambda p, b: self._logits(p, b["state"], b[self.aux_key]), live, batch, self.gamma,
            self.actor_weight, self.entropy_weight)
        self.params, self.opt_state = optimizer_step(self.optimizer, self.params, self.opt_state, loss, leaves)
        return actor_loss.detach(), entropy_loss.detach()


class MaskedReinforceAgent(_ReinforceBase):
    """104-logit masked-softmax REINFORCE (reference policy.py:15-106)."""

    aux_key = "legal_mask"

    def _build_spec(self, hidden_sizes) -> MLPSpec:
        return MLPSpec(input_size=self.state_length, hidden_sizes=hidden_sizes, head_sizes=(self.num_actions,))

    def _logits(self, params, state, aux):
        return masked_policy_logits(self.spec, params, state, aux)

    @torch.no_grad()
    def forward(self, state, legal_actions, **kwargs):
        state = np.asarray(state, np.float32)
        mask = np.zeros(self.num_actions, dtype=bool)
        mask[legal_actions] = True
        logits = self._logits(self.params, self._tensor(state), self._tensor(mask))
        action = sample_index(logits, self.generator)
        logp, entropy = log_probs_and_entropy(logits)
        info = {
            "log_prob": float(logp[action]),
            "entropy": float(entropy),
            "step_record": {"state": state, "legal_mask": mask, "chosen": np.int32(action)},
        }
        return action, info


class BatchedReinforceAgent(_ReinforceBase):
    """Action-in-input REINFORCE; the registry's ``"reinforce"``."""

    aux_key = "legal_cards"

    def _build_spec(self, hidden_sizes) -> MLPSpec:
        return MLPSpec(input_size=self.state_length + 1, hidden_sizes=hidden_sizes, head_sizes=(1,))

    def _logits(self, params, state, aux):
        return action_in_input_logits(self.spec, params, state, aux)

    @torch.no_grad()
    def forward(self, state, legal_actions, **kwargs):
        state = np.asarray(state, np.float32)
        padded = pad_cards(legal_actions, self.env_config.hand_size)
        logits = self._logits(self.params, self._tensor(state), self._tensor(padded))
        idx = sample_index(logits, self.generator)
        logp, entropy = log_probs_and_entropy(logits)
        info = {
            "log_prob": float(logp[idx]),
            "entropy": float(entropy),
            "step_record": {"state": state, "legal_cards": padded, "chosen": np.int32(idx)},
        }
        return int(legal_actions[idx]), info
