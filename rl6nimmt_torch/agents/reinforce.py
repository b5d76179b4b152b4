"""The REINFORCE policy nets' pure functions (port of ``agents/reinforce.py:47-105``).

Only the net math the search agents need is ported here:

* :func:`masked_policy_logits` -- a 104-logit head masked to the legal cards;
* :func:`action_in_input_logits` / :func:`action_in_input_heads` -- the
  "action-in-input" net: one row ``[action | state]`` per candidate card
  through a 1-logit (or wider) head;
* :func:`log_probs_and_entropy`.

All take any leading batch axes (the JAX functions took one state and were
vmapped), so one call serves every seat of every playout.  The loss and the
agents (``reinforce_loss``, ``MaskedReinforceAgent``, ``BatchedReinforceAgent``)
are ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import torch

from ..nets import MLPSpec, linear_apply, mlp_apply, normalize_state
from ..nets.mlp import _activation

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

    Layers past the first run on the ``[..., H, hidden]`` batch.
    """
    act = _activation(spec.activation)
    state_norm = normalize_state(state)                                   # [..., S]
    # The action feature's normalization: the first block of the action=True layout.
    a_norm = -1.0 + 2.0 * legal_cards.to(torch.float32) / (CARDS - 1)      # [..., H]
    first = params["trunk"][0]
    w, b = first["w"], first["b"]                                          # [1+S, D], [D]
    shared = state_norm @ w[1:] + b                                        # [..., D]
    h = act(shared[..., None, :] + a_norm[..., :, None] * w[0])            # [..., H, D]
    for layer in params["trunk"][1:]:
        h = act(linear_apply(layer, h))
    return tuple(linear_apply(head, h) for head in params["heads"])


def log_probs_and_entropy(logits):
    """``(log_softmax(logits), entropy)`` over the last axis."""
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    entropy = -torch.sum(torch.where(p > 0, p * logp, 0.0), dim=-1)
    return logp, entropy
