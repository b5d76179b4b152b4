"""Agents and the agent registry (port of ``rl6nimmt_tpu.agents``; mirrors the
reference's agents/__init__.py).

:data:`AGENTS` maps the reference's 19 keys plus ``puct_uniform`` to their
classes.  Beside it: the DQN learner's functional core, the REINFORCE and ACER
agents and their losses, the search agents in :mod:`.mcs` (their decisions in
:mod:`.device_search`, their playouts in :mod:`.search`).
"""

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
    DQN_VARIANTS,
    MASK_VALUE,
    Adam,
    AdamState,
    D3QN_PRB_NStep,
    DDQN_PRBAgent,
    DDQNAgent,
    DQN_NStep_Agent,
    DQN_PRBAgent,
    DQNAgent,
    DQNConfig,
    DQNVanilla,
    DuellingDDQN_PRBAgent,
    DuellingDDQNAgent,
    DuellingDQNAgent,
    Noisy_D3QN,
    Noisy_D3QN_PRB_NStep,
    Noisy_DQN,
    Sgd,
    eps_func_decay,
    learn_noise,
    make_learn_step,
    q_network_spec,
    q_values,
)
from .human import Human
from .mcs import BaseMCAgent, MCSAgent, PolicyMCSAgent, PUCTAgent, PUCTCustomedAgent, PUCTUniformAgent
from .random_agent import DrunkHamster
from .reinforce import BatchedReinforceAgent, MaskedReinforceAgent, reinforce_loss

HUMAN = "human"
RANDOM_AGENT = "random"
REINFORCE = "reinforce"
ACER = "acer"
DQN = "dqn"
DDQN = "ddqn"
DQN_PRB = "dqn_prb"
DDQN_PRB = "ddqn_prb"
DUELLING_DDQN_PRB = "duelling_ddqn_prb"
DQN_NSTEP = "dqn_nstep"
D3QN_PRB_NSTEP = "d3qn_prb_nstep"
NOISY_DQN = "noisy_dqn"
NOISY_D_QN_PRB_NSTEP = "noisy_d3qn_prb_nstep"
DUELLING_DQN = "duelling_dqn"
DUELLING_DDQN = "duelling_ddqn"
NOISY_D3QN = "noisy_d3qn"
MCS = "mcts"
PMCS = "pmcs"
PUCT = "puct"
# Framework-original (no reference analog): decoupled Alpha0.5, net prior at
# the root only (PUCTUniformAgent); every reference key keeps its meaning.
PUCT_UNIFORM = "puct_uniform"

AGENTS = {
    HUMAN: Human,
    RANDOM_AGENT: DrunkHamster,
    REINFORCE: BatchedReinforceAgent,
    ACER: BatchedACERAgent,
    DQN: DQNVanilla,
    DDQN: DDQNAgent,
    DUELLING_DQN: DuellingDQNAgent,
    DUELLING_DDQN: DuellingDDQNAgent,
    DQN_PRB: DQN_PRBAgent,
    DDQN_PRB: DDQN_PRBAgent,
    DUELLING_DDQN_PRB: DuellingDDQN_PRBAgent,
    DQN_NSTEP: DQN_NStep_Agent,
    D3QN_PRB_NSTEP: D3QN_PRB_NStep,
    NOISY_DQN: Noisy_DQN,
    NOISY_D_QN_PRB_NSTEP: Noisy_D3QN_PRB_NStep,
    NOISY_D3QN: Noisy_D3QN,
    MCS: MCSAgent,
    PMCS: PolicyMCSAgent,
    PUCT: PUCTAgent,
    PUCT_UNIFORM: PUCTUniformAgent,
}

POLICY_METHODS = [REINFORCE, ACER]
DDQN_METHODS = [DDQN, DUELLING_DDQN, DDQN_PRB, DUELLING_DDQN_PRB, NOISY_D_QN_PRB_NSTEP, NOISY_D3QN, D3QN_PRB_NSTEP]
NSTEP_METHODS = [DQN_NSTEP, D3QN_PRB_NSTEP, NOISY_D_QN_PRB_NSTEP]
NOISY_METHODS = [NOISY_DQN, NOISY_D_QN_PRB_NSTEP, NOISY_D3QN]

__all__ = [
    "Agent",
    "AGENTS",
    "BaseMCAgent",
    "BatchedACERAgent",
    "BatchedActionValueActorCriticAgent",
    "BatchedReinforceAgent",
    "D3QN_PRB_NStep",
    "DDQN_PRBAgent",
    "DDQNAgent",
    "DQN_NStep_Agent",
    "DQN_PRBAgent",
    "DQNAgent",
    "DQNConfig",
    "DQNVanilla",
    "DrunkHamster",
    "DuellingDDQN_PRBAgent",
    "DuellingDDQNAgent",
    "DuellingDQNAgent",
    "Human",
    "MCSAgent",
    "MaskedReinforceAgent",
    "Noisy_D3QN",
    "Noisy_D3QN_PRB_NStep",
    "Noisy_DQN",
    "PolicyMCSAgent",
    "PUCTAgent",
    "PUCTCustomedAgent",
    "PUCTUniformAgent",
    # the port's functional cores, exported since its first slices
    "Adam",
    "AdamState",
    "DQN_VARIANTS",
    "LOG_EPSILON",
    "MASK_VALUE",
    "Sgd",
    "acer_qret",
    "actor_critic_heads",
    "eps_func_decay",
    "learn_noise",
    "make_acer_train_step",
    "make_learn_step",
    "q_network_spec",
    "q_values",
    "reinforce_loss",
]
