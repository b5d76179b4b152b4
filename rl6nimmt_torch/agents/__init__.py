"""Agents (port of ``rl6nimmt_tpu.agents``): the DQN learner's functional core,
the REINFORCE and ACER agents and their losses, the search agents in
:mod:`.mcs` (their decisions in :mod:`.device_search`, their playouts in
:mod:`.search`).  The 20-key registry comes with the tournament (ROADMAP
queue 1 item 8)."""

from .acer import (
    LOG_EPSILON,
    BatchedACERAgent,
    BatchedActionValueActorCriticAgent,
    acer_qret,
    actor_critic_heads,
    make_acer_train_step,
)
from .base import Agent
from .dqn import (
    MASK_VALUE,
    Adam,
    AdamState,
    DQNConfig,
    Sgd,
    learn_noise,
    make_learn_step,
    q_network_spec,
    q_values,
)
from .mcs import MCSAgent, PolicyMCSAgent, PUCTAgent, PUCTCustomedAgent, PUCTUniformAgent
from .reinforce import BatchedReinforceAgent, MaskedReinforceAgent, reinforce_loss

__all__ = [
    "Adam",
    "AdamState",
    "Agent",
    "BatchedACERAgent",
    "BatchedActionValueActorCriticAgent",
    "BatchedReinforceAgent",
    "DQNConfig",
    "LOG_EPSILON",
    "MASK_VALUE",
    "MCSAgent",
    "MaskedReinforceAgent",
    "PUCTAgent",
    "PUCTCustomedAgent",
    "PUCTUniformAgent",
    "PolicyMCSAgent",
    "Sgd",
    "acer_qret",
    "actor_critic_heads",
    "learn_noise",
    "make_acer_train_step",
    "make_learn_step",
    "q_network_spec",
    "q_values",
    "reinforce_loss",
]
