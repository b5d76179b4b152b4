"""The DQN family (port of ``agents/dqn.py``): the functional core and the host agent.

:class:`DQNConfig` flags span the reference lattice (double / dueling /
noisy / PER / n-step).  :func:`make_learn_step` is the Bellman update:
PyTorch autograd through the functional nets plus :class:`Adam`, a
functional copy of ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias correction as optax computes it).  Double-DQN soft-updates
the target with tau 0.01 when ``do_soft_update``.

Noise is injected: a noisy learn step takes the ``(noise_eval, noise_tgt)``
pair that :func:`learn_noise` draws from a ``torch.Generator``.

:class:`DQNAgent` is the lattice as one configurable host learner
(dqn.py:199-392): the reference's 11 classes plus ``DQNVanilla`` are
:func:`_variant` subclasses that differ only in their :class:`DQNConfig`
(:data:`DQN_VARIANTS`).  Behavioural parity notes, as in JAX:

* epsilon schedule ``max(exp(-0.0025 * episode), 0.05)`` refreshed in
  ``learn`` (dqn.py:34-39, 92); noisy variants act by pure argmax;
* illegal actions are masked to -1e8 only at act time; the Bellman max runs
  over all 104 actions (dqn.py:182-194);
* the stored ``reward`` is the session's lagged reward (play.py:52-71);
* n-step aggregation keeps the popped step's ``done`` flag and flushes the
  episode tail with ``done=True`` (dqn.py:270-301);
* double DQN soft-updates the target every ``retrain_interval`` learn steps
  with ``tau = 1e-2``; PER uses IS-weighted squared error and writes back
  ``|q_eval - q_target|`` (dqn.py:304-379).

Epsilon draws and the replay minibatches come from NumPy's global generator,
as in JAX; the noisy nets' noise from the agent's generator
(:meth:`DQNAgent._act_noise`, :meth:`DQNAgent._learn_noise`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from ..buffers.host import HostHistory, HostPriorityBuffer
from ..nets import MLPSpec, draw_mlp_noise, dueling_apply, mlp_apply, mlp_init
from ..utils.ops import onehot_select, pmean_fused
from .base import Agent

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
        # Bias corrections in float32, as optax computes ``1 - decay**count``,
        # placed on the device by a fill: copying a CPU tensor there would
        # wait for the card, and a CPU scalar operand turns the division into
        # a multiplication by its reciprocal on CUDA.
        dev = tree_leaves(state.mu)[0].device
        bc1 = torch.full((), float(1 - torch.tensor(b1, dtype=torch.float32) ** count), device=dev)
        bc2 = torch.full((), float(1 - torch.tensor(b2, dtype=torch.float32) ** count), device=dev)

        def upd(m, v):
            m_hat = m / bc1
            v_hat = v / bc2
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


def make_learn_step(cfg: DQNConfig, spec: MLPSpec, optimizer: Adam, gamma: float, axis_name=None):
    """Build the Bellman update.

    ``learn_step(params, target_params, opt_state, batch, do_soft_update,
    noise=None) -> (params, target_params, opt_state, loss, abs_err,
    q_target)``; ``batch`` holds ``state/action/reward/next_state/done/
    weights`` with a leading minibatch axis.  ``noise`` is required for
    noisy configs (:func:`learn_noise`).  Returned params are new tensors;
    the inputs are not modified.

    With ``axis_name`` (a process group, or a tuple of them: the groups of a
    :class:`~..parallel.mesh.Mesh`) the gradients and the loss are averaged
    over the ranks in one all-reduce before the optimizer applies them
    (:func:`~..utils.ops.pmean_fused`); ``abs_err`` (the PER priorities)
    stays this rank's own, as in JAX.
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
        grads, loss = grads_of(loss, leaves, params), loss.detach()
        if axis_name is not None:
            grads, loss = pmean_fused((grads, loss), axis_name)
        new_params, opt_state = optimizer_apply(optimizer, params, opt_state, grads)
        with torch.no_grad():
            if cfg.double and do_soft_update:
                tau = cfg.tau
                target_params = tree_map(lambda t, l: tau * l + (1.0 - tau) * t,
                                         target_params, new_params)
        return new_params, target_params, opt_state, loss, err.detach().abs(), q_target

    return learn_step


def learn_noise(cfg: DQNConfig, spec: MLPSpec, generator: torch.Generator):
    """The noise one learn step consumes: ``(noise_eval, noise_tgt)``.

    ``noise_tgt`` is ``(online, target)`` for double DQN, else ``(online,)``.
    """
    noise_eval = draw_mlp_noise(spec, generator)
    if cfg.double:
        return noise_eval, (draw_mlp_noise(spec, generator), draw_mlp_noise(spec, generator))
    return noise_eval, (draw_mlp_noise(spec, generator),)


# ------------------------------------------------------------------ host agent


def eps_func_decay(episode: int) -> float:
    """Exponential epsilon decay with floor 0.05 (reference dqn.py:34-39)."""
    return max(math.exp(-0.0025 * episode), 0.05)


class DQNAgent(Agent):
    """Configurable deep Q-learner covering the reference lattice."""

    dqn_config: DQNConfig = DQNConfig()

    def __init__(
        self,
        env=None,
        gamma: float = 0.99,
        optim_kwargs=None,
        history_length: Optional[int] = None,
        hidden_sizes: Optional[Tuple[int, ...]] = None,
        n_steps: Optional[int] = None,
        eps_func=None,
        minibatch: Optional[int] = None,
        seed: Optional[int] = None,
        summary_writer=None,
        device="cuda",
        **kwargs,
    ):
        super().__init__(env, gamma, optim_kwargs, history_length, seed=seed, device=device)
        cfg = self.dqn_config
        if hidden_sizes is not None:
            cfg = replace(cfg, hidden_sizes=tuple(hidden_sizes))
        if n_steps is not None:
            cfg = replace(cfg, n_steps=int(n_steps))
        if minibatch is not None:
            cfg = replace(cfg, minibatch=int(minibatch))
        self.cfg = cfg
        self.summary_writer = summary_writer

        self.spec = q_network_spec(cfg, self.state_length, self.num_actions)
        self.params = mlp_init(self.generator, self.spec, self.device)
        # Hard-copy target at init (reference soft_update(tau=1), dqn.py:321).
        self.target_params = tree_map(torch.clone, self.params) if cfg.double else None

        self.eps_func = eps_func or eps_func_decay
        self.eps = 0.0
        self.step = 0
        self._n_step_buffer = []
        if cfg.per:
            self.history = HostPriorityBuffer(history_length or 100_000)
        else:
            self.history = HostHistory(history_length)
        self._rebuild()

    # ------------------------------------------------------------- plumbing

    def _rebuild(self) -> None:
        """The learn step, a closure, exists only in training mode; pickles drop it."""
        self._learn_step = None
        if self.training and self.optimizer is not None:
            self._learn_step = make_learn_step(self.cfg, self.spec, self.optimizer, self.gamma)

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_learn_step", None)
        return state

    def __setstate__(self, state):
        super().__setstate__(state)
        if self.training:
            # JAX's unpickling re-enters train(True), which resets epsilon.
            self.eps = self.eps_func(0)
        self._rebuild()

    def parameters(self):
        return self.params

    def set_parameters(self, params) -> None:
        self.params = params
        if self.cfg.double:
            self.target_params = tree_map(torch.clone, params)

    def train(self, mode: bool = True) -> None:
        super().train(mode)
        self.eps = self.eps_func(0)
        self._rebuild()

    def _act_noise(self):
        """One forward's factorized noise, from the agent's generator."""
        return draw_mlp_noise(self.spec, self.generator)

    def _learn_noise(self):
        """One update's noise (:func:`learn_noise`), from the agent's generator."""
        return learn_noise(self.cfg, self.spec, self.generator)

    # ------------------------------------------------------------------ act

    @torch.no_grad()
    def forward(self, state, legal_actions=None, **kwargs):
        state = np.asarray(state, np.float32)
        noise = self._act_noise() if self.cfg.noisy else None
        scores = q_values(self.cfg, self.spec, self.params, self._tensor(state[None]), noise)[0].cpu().numpy()

        if self.cfg.noisy:
            # Pure argmax over the legal subset (reference dqn.py:251-261).
            if legal_actions:
                sub = scores[legal_actions]
                pick = int(np.argmax(sub))
                return int(legal_actions[pick]), {"value": float(sub[pick])}
            return int(np.argmax(scores)), {"value": float(np.max(scores))}

        # Epsilon-greedy with -1e8 masking (reference dqn.py:196-217).
        if legal_actions:
            illegal = np.setdiff1d(np.arange(self.num_actions), legal_actions)
            scores[illegal] = MASK_VALUE
        if np.random.random() > self.eps:
            action = int(np.argmax(scores))
            value = float(np.max(scores))
        else:
            action = int(np.random.choice(legal_actions if legal_actions else self.num_actions))
            value = -1.0
        return action, {"value": value, "eps": self.eps}

    # ---------------------------------------------------------------- learn

    def learn(
        self, state, reward, action, done, next_state, next_reward, episode_end, num_episode,
        legal_actions=None, **kwargs,
    ):
        self.step += 1
        self.eps = self.eps_func(num_episode)
        loss = 0.0

        # Reference's TensorBoard hook: eps once per episode (dqn.py:97-98).
        if self.summary_writer is not None and episode_end:
            self.summary_writer.add_scalar("debug/eps", self.eps, num_episode)

        self._store(
            state=np.asarray(state, np.float32),
            reward=float(reward),
            action=int(action),
            next_state=np.asarray(next_state, np.float32),
            done=bool(done),
        )

        if len(self.history) > self.cfg.minibatch and self.training:
            loss = self._learn(num_episode, episode_end)

        if done:
            self._finish_episode()
        return np.asarray([loss])

    def _store(self, **experience) -> None:
        cfg = self.cfg
        if cfg.n_steps <= 1:
            self.history.store(**experience)
            return
        self._n_step_buffer.append(experience)
        if len(self._n_step_buffer) < cfg.n_steps:
            return
        R = sum(self._n_step_buffer[i]["reward"] * (self.gamma**i) for i in range(cfg.n_steps))
        head = self._n_step_buffer.pop(0)
        head["reward"] = R
        head["next_state"] = experience["next_state"]
        self.history.store(**head)

    def _finish_episode(self) -> None:
        # Flush the n-step tail with done=True (reference dqn.py:288-301).
        if not self._n_step_buffer:
            return
        last = self._n_step_buffer[-1]
        while self._n_step_buffer:
            R = sum(self._n_step_buffer[i]["reward"] * (self.gamma**i) for i in range(len(self._n_step_buffer)))
            head = self._n_step_buffer.pop(0)
            head["reward"] = R
            head["next_state"] = last["next_state"]
            head["done"] = True
            self.history.store(**head)

    def _learn(self, num_episode: int = 0, episode_end: bool = False) -> float:
        idx, weights, raw = self.history.sample(self.cfg.minibatch)
        batch = {
            "state": np.stack(raw["state"]),
            "action": np.asarray(raw["action"], np.int64),
            "reward": np.asarray(raw["reward"], np.float32),
            "next_state": np.stack(raw["next_state"]),
            "done": np.asarray(raw["done"], np.float32),
            "weights": (np.asarray(weights, np.float32) if weights is not None
                        else np.ones(self.cfg.minibatch, np.float32)),
        }
        batch = {k: self._tensor(v) for k, v in batch.items()}
        do_soft = (self.step % self.cfg.retrain_interval) == 0
        noise = self._learn_noise() if self.cfg.noisy else None
        self.params, self.target_params, self.opt_state, loss, abs_err, q_target = self._learn_step(
            self.params, self.target_params, self.opt_state, batch, do_soft, noise)
        # Reference's TensorBoard hook: max Bellman target every 10th episode (dqn.py:134-135).
        if self.summary_writer is not None and episode_end and num_episode % 10 == 0:
            self.summary_writer.add_scalar("debug/bellman_target", float(q_target.max()), num_episode)
        if self.cfg.per:
            self.history.batch_update(idx, abs_err.cpu().numpy())
        return float(loss)


# ------------------------------------------------- reference class lattice


def _variant(name: str, **flags) -> type:
    return type(name, (DQNAgent,), {"dqn_config": DQNConfig(**flags)})


DQNVanilla = _variant("DQNVanilla")
Noisy_DQN = _variant("Noisy_DQN", noisy=True)
# The "NStep" classes default to n_steps=1 exactly like the reference (ref
# dqn.py:45); they are n-step only when built with n_steps=N (the notebook's
# flagship uses n_steps=10).
DQN_NStep_Agent = _variant("DQN_NStep_Agent")
DDQNAgent = _variant("DDQNAgent", double=True)
DQN_PRBAgent = _variant("DQN_PRBAgent", per=True)
DuellingDQNAgent = _variant("DuellingDQNAgent", dueling=True)
DuellingDDQNAgent = _variant("DuellingDDQNAgent", double=True, dueling=True)
Noisy_D3QN = _variant("Noisy_D3QN", double=True, dueling=True, noisy=True)
DDQN_PRBAgent = _variant("DDQN_PRBAgent", double=True, per=True)
DuellingDDQN_PRBAgent = _variant("DuellingDDQN_PRBAgent", double=True, dueling=True, per=True)
D3QN_PRB_NStep = _variant("D3QN_PRB_NStep", double=True, dueling=True, per=True)
Noisy_D3QN_PRB_NStep = _variant("Noisy_D3QN_PRB_NStep", double=True, dueling=True, per=True, noisy=True)

DQN_VARIANTS = {
    "dqn": DQNVanilla,
    "noisy_dqn": Noisy_DQN,
    "dqn_nstep": DQN_NStep_Agent,
    "ddqn": DDQNAgent,
    "dqn_prb": DQN_PRBAgent,
    "duelling_dqn": DuellingDQNAgent,
    "duelling_ddqn": DuellingDDQNAgent,
    "noisy_d3qn": Noisy_D3QN,
    "ddqn_prb": DDQN_PRBAgent,
    "duelling_ddqn_prb": DuellingDDQN_PRBAgent,
    "d3qn_prb_nstep": D3QN_PRB_NStep,
    "noisy_d3qn_prb_nstep": Noisy_D3QN_PRB_NStep,
}
