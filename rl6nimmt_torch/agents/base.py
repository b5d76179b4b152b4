"""Agent protocol for the interactive (host) game path (port of ``agents/base.py``).

An agent exposes

* ``forward(state, legal_actions, **kwargs) -> (action, agent_info)`` -- pick
  a card given the per-player observation and the list of held card ids;
* ``learn(state, reward, action, done, next_state, next_reward, episode_end,
  num_episode, legal_actions, **agent_info)`` -- called once per step by the
  game session, with the *previous* step's reward in ``reward`` and the fresh
  one in ``next_reward`` (the reference's reward-lag protocol).

Parameters and optimizer state are explicit trees of tensors on the agent's
``device``; ``train()`` (re)creates the functional :class:`~.dqn.Adam` as the
JAX agent recreated optax's Adam on every call.  Randomness comes from the
agent's own ``torch.Generator`` on that device (the JAX agent split a PRNG
key with ``next_key``).  The JAX agent kept its parameters on the host CPU
and restaged them onto the accelerator for playouts; here they live where the
agent plays.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from ..engine.state import EnvConfig
from ..utils.device import resolve_device

DEFAULT_ENV_CONFIG = EnvConfig(num_players=4)


def pad_cards(legal_actions, width: int) -> np.ndarray:
    """Legal-card list -> fixed-width int32 vector padded with -1.

    The padding convention shared by every action-in-input agent and the
    search agents' step records (pad value -1 marks illegal slots).
    """
    padded = np.full(width, -1, dtype=np.int32)
    padded[: len(legal_actions)] = legal_actions
    return padded


class Agent:
    """Base class for host-path agents."""

    def __init__(
        self,
        env: Optional[EnvConfig] = None,
        gamma: float = 0.99,
        optim_kwargs: Optional[dict] = None,
        history_length: Optional[int] = None,
        seed: Optional[int] = None,
        device="cuda",
    ):
        self.env_config = env if env is not None else DEFAULT_ENV_CONFIG
        self.gamma = gamma
        self.state_length = self.env_config.state_length
        self.num_actions = self.env_config.num_actions
        self.optim_kwargs = dict(optim_kwargs or {})
        self.history_length = history_length
        self.optimizer = None
        self.opt_state = None
        self.training = False
        self.device = resolve_device(device)
        # As the JAX agent: an unseeded agent takes its seed from NumPy's global generator.
        seed = np.random.randint(0, 2**31 - 1) if seed is None else seed
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    # ---------------------------------------------------- (de)serialization
    #
    # Agents are picklable: the generator travels as its state and is rebuilt
    # on its device on load.  Cloning is an in-memory pickle cycle.

    def __getstate__(self):
        state = dict(self.__dict__)
        state["generator"] = state["generator"].get_state()
        return state

    def __setstate__(self, state):
        state = dict(state)
        rng_state = state.pop("generator")
        self.__dict__.update(state)
        self.generator = torch.Generator(device=self.device)
        self.generator.set_state(rng_state)

    def clone(self) -> "Agent":
        return pickle.loads(pickle.dumps(self))

    # --------------------------------------------------------------- plumbing

    def _tensor(self, x) -> torch.Tensor:
        """``x`` (array-like) as a tensor on the agent's device."""
        return torch.from_numpy(np.asarray(x)).to(self.device)

    def parameters(self):
        """The trainable parameter tree (None for learning-free agents)."""
        return None

    def set_parameters(self, params) -> None:
        raise NotImplementedError(f"{type(self).__name__} has no parameters")

    def train(self, mode: bool = True) -> None:
        """Enter/leave training mode; (re)creates Adam like the reference."""
        from .dqn import Adam

        self.training = mode
        if mode and self.parameters() is not None:
            betas = self.optim_kwargs.get("betas", (0.9, 0.999))
            self.optimizer = Adam(self.optim_kwargs.get("lr", 1e-3), b1=betas[0], b2=betas[1],
                                  eps=self.optim_kwargs.get("eps", 1e-8))
            self.opt_state = self.optimizer.init(self.parameters())

    def eval(self) -> None:
        self.train(mode=False)

    def __call__(self, state, legal_actions, **kwargs):
        return self.forward(state, legal_actions, **kwargs)

    # ------------------------------------------------------------- interface

    def forward(self, state, legal_actions, **kwargs):
        raise NotImplementedError

    def learn(
        self,
        state,
        reward,
        action,
        done,
        next_state,
        next_reward,
        episode_end,
        num_episode,
        legal_actions,
        **kwargs,
    ):
        raise NotImplementedError
