"""Data parallelism over ``torch.distributed`` (port of ``rl6nimmt_tpu.parallel``)."""

from .mesh import (
    DCN_AXIS,
    GAMES_AXIS,
    ICI_AXIS,
    game_sharding,
    make_dp_acer_step,
    make_dp_dqn_step,
    make_dp_reinforce_step,
    make_mesh,
    make_mesh_2level,
    mesh_axes,
    replicated,
    stack_for_mesh,
)

__all__ = [
    "DCN_AXIS",
    "GAMES_AXIS",
    "ICI_AXIS",
    "game_sharding",
    "make_dp_acer_step",
    "make_dp_dqn_step",
    "make_dp_reinforce_step",
    "make_mesh",
    "make_mesh_2level",
    "mesh_axes",
    "replicated",
    "stack_for_mesh",
]
