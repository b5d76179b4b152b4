"""Agents (port of ``rl6nimmt_tpu.agents``): the DQN learner's functional core,
re-exported here; the search agents are in :mod:`.mcs`, their decisions in
:mod:`.device_search` and their playouts in :mod:`.search`."""

from .dqn import (
    MASK_VALUE,
    Adam,
    AdamState,
    DQNConfig,
    learn_noise,
    make_learn_step,
    q_network_spec,
    q_values,
)

__all__ = [
    "Adam",
    "AdamState",
    "DQNConfig",
    "MASK_VALUE",
    "learn_noise",
    "make_learn_step",
    "q_network_spec",
    "q_values",
]
