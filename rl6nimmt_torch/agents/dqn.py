"""The DQN learner's functional core (port of ``agents/dqn.py:43-196``).

:class:`DQNConfig` flags span the reference lattice (double / dueling /
noisy / PER / n-step).  :func:`make_learn_step` is the Bellman update:
PyTorch autograd through the functional nets plus :class:`Adam`, a
functional copy of ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias correction as optax computes it).  Double-DQN soft-updates
the target with tau 0.01 when ``do_soft_update``.

Noise is injected: a noisy learn step takes the ``(noise_eval, noise_tgt)``
pair that :func:`learn_noise` draws from a ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..nets import MLPSpec, draw_mlp_noise, dueling_apply, mlp_apply
from ..utils.ops import onehot_select

MASK_VALUE = -1e8


@dataclass(frozen=True)
class DQNConfig:
    """Feature flags spanning the reference's class lattice."""

    double: bool = False
    dueling: bool = False
    noisy: bool = False
    per: bool = False
    n_steps: int = 1
    hidden_sizes: Tuple[int, ...] = (64,)
    minibatch: int = 64
    tau: float = 1e-2
    retrain_interval: int = 4
    noisy_init_sigma: float = 0.5


def q_network_spec(cfg: DQNConfig, state_length: int, num_actions: int) -> MLPSpec:
    head_sizes = (1, num_actions) if cfg.dueling else (num_actions,)
    return MLPSpec(input_size=state_length, hidden_sizes=cfg.hidden_sizes,
                   head_sizes=head_sizes, noisy=cfg.noisy, sigma_init=cfg.noisy_init_sigma)


def q_values(cfg: DQNConfig, spec: MLPSpec, params, states, noise=None):
    """Q(s, .) for a batch of raw states."""
    if cfg.dueling:
        return dueling_apply(spec, params, states, noise)
    (q,) = mlp_apply(spec, params, states, noise)
    return q


# ------------------------------------------------------------------- pytrees


def tree_map(fn, *trees):
    """Map over the ``{"trunk": [dict], "heads": [dict]}`` parameter tree."""
    return {part: [{k: fn(*(t[part][i][k] for t in trees)) for k in layer}
                   for i, layer in enumerate(trees[0][part])]
            for part in ("trunk", "heads")}


def tree_leaves(tree):
    return [layer[k] for part in ("trunk", "heads") for layer in tree[part] for k in layer]


def tree_unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


# ---------------------------------------------------------------------- Adam


@dataclass
class AdamState:
    count: int
    mu: dict
    nu: dict


@dataclass(frozen=True)
class Adam:
    """Functional ``optax.adam``: ``update(grads, state) -> (updates, state')``."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> AdamState:
        zeros = tree_map(lambda p: torch.zeros_like(p), params)
        return AdamState(0, zeros, tree_map(lambda p: torch.zeros_like(p), params))

    def update(self, grads, state: AdamState):
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state.nu)
        count = state.count + 1
        # Bias corrections in float32, as optax computes ``1 - decay**count``.
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count

        def upd(m, v):
            m_hat = m / bc1.to(m.device)
            v_hat = v / bc2.to(v.device)
            return (m_hat / (torch.sqrt(v_hat) + self.eps)) * (-self.lr)

        return tree_map(upd, mu, nu), AdamState(count, mu, nu)


@dataclass(frozen=True)
class Sgd:
    """Functional ``optax.sgd``: updates ``-lr * grad``, no state.

    The parity checks compare parameters after an update under it: an update
    linear in the gradient keeps round-off at round-off, where Adam's first
    step moves every parameter by about ``lr`` whatever its gradient's size
    (the policy head's bias has a zero gradient by construction, the softmax
    being shift-invariant, so both sides step it by their round-off's sign).
    """

    lr: float = 1e-2

    def init(self, params):
        return None

    def update(self, grads, state):
        return tree_map(lambda g: -self.lr * g, grads), state


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def grad_leaves(params):
    """``(leaves, live)``: fresh leaves that require grad and the tree over them."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    return leaves, tree_unflatten(params, leaves)


def grads_of(loss: torch.Tensor, leaves, like):
    """The gradient of ``loss`` w.r.t. ``leaves`` (the :func:`grad_leaves` of
    the tree ``like``) as a tree; a leaf the loss does not reach gets zeros,
    as ``jax.grad`` gives."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_unflatten(like, [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)])


@torch.no_grad()
def optimizer_apply(optimizer, params, opt_state, grads):
    """One step of ``optimizer`` (:class:`Adam` or :class:`Sgd`): ``(params', opt_state')``, new tensors."""
    updates, opt_state = optimizer.update(grads, opt_state)
    return apply_updates(tree_map(lambda p: p.detach(), params), updates), opt_state


def optimizer_step(optimizer, params, opt_state, loss: torch.Tensor, leaves):
    """:func:`grads_of` then :func:`optimizer_apply`."""
    return optimizer_apply(optimizer, params, opt_state, grads_of(loss, leaves, params))


# ------------------------------------------------------------------- learner


def make_learn_step(cfg: DQNConfig, spec: MLPSpec, optimizer: Adam, gamma: float):
    """Build the Bellman update.

    ``learn_step(params, target_params, opt_state, batch, do_soft_update,
    noise=None) -> (params, target_params, opt_state, loss, abs_err,
    q_target)``; ``batch`` holds ``state/action/reward/next_state/done/
    weights`` with a leading minibatch axis.  ``noise`` is required for
    noisy configs (:func:`learn_noise`).  Returned params are new tensors;
    the inputs are not modified.
    """

    def bellman_target(params, target_params, batch, noise_tgt):
        not_done = 1.0 - batch["done"]
        if cfg.double:
            n1, n2 = noise_tgt if noise_tgt is not None else (None, None)
            q_local = q_values(cfg, spec, params, batch["next_state"], n1)
            q_target = q_values(cfg, spec, target_params, batch["next_state"], n2)
            bootstrap = onehot_select(q_target, torch.argmax(q_local, dim=-1))
        else:
            n1 = noise_tgt[0] if noise_tgt is not None else None
            bootstrap = q_values(cfg, spec, params, batch["next_state"], n1).max(dim=-1).values
        return batch["reward"] + (gamma ** cfg.n_steps) * bootstrap * not_done

    def learn_step(params, target_params, opt_state, batch, do_soft_update, noise=None):
        if cfg.noisy and noise is None:
            raise ValueError("noisy configs need injected learn noise (learn_noise)")
        noise_eval, noise_tgt = noise if cfg.noisy else (None, None)
        leaves, live = grad_leaves(params)
        q = q_values(cfg, spec, live, batch["state"], noise_eval)
        q_eval = onehot_select(q, batch["action"])
        with torch.no_grad():
            detached = tree_map(lambda p: p.detach(), params)
            q_target = bellman_target(detached, target_params, batch, noise_tgt)
        err = q_eval - q_target
        if cfg.per:
            loss = torch.mean(batch["weights"] * err ** 2)
        else:
            loss = torch.mean(err ** 2)
        new_params, opt_state = optimizer_apply(optimizer, params, opt_state, grads_of(loss, leaves, params))
        with torch.no_grad():
            if cfg.double and do_soft_update:
                tau = cfg.tau
                target_params = tree_map(lambda t, l: tau * l + (1.0 - tau) * t,
                                         target_params, new_params)
        return (new_params, target_params, opt_state, loss.detach(),
                err.detach().abs(), q_target)

    return learn_step


def learn_noise(cfg: DQNConfig, spec: MLPSpec, generator: torch.Generator):
    """The noise one learn step consumes: ``(noise_eval, noise_tgt)``.

    ``noise_tgt`` is ``(online, target)`` for double DQN, else ``(online,)``.
    """
    noise_eval = draw_mlp_noise(spec, generator)
    if cfg.double:
        return noise_eval, (draw_mlp_noise(spec, generator), draw_mlp_noise(spec, generator))
    return noise_eval, (draw_mlp_noise(spec, generator),)
