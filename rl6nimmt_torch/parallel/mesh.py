"""Process-group mesh and data-parallel steps (port of ``parallel/mesh.py``).

JAX ran one program over a ``jax.sharding.Mesh``: the games axis sharded
over its devices, parameters replicated, gradients reduced with
``lax.pmean`` inside ``shard_map``.  Here every rank is a process of an
initialized ``torch.distributed`` default group (gloo on the CPU, NCCL or
gloo on the card) and a :class:`Mesh` names this rank's place in it:

* :func:`make_mesh` -- one ``games`` axis over the first ranks;
* :func:`make_mesh_2level` -- axes ``("dcn", "ici")``: ranks in row-major
  order, a group per slice (``ici``) and a group per in-slice index
  (``dcn``); a reduce over both axes sums inside the slice, then across
  slices;
* :func:`game_sharding` -- this rank's contiguous slice of a games axis, and
  the ``all_gather`` that brings every rank's slice back;
* :func:`replicated` -- check that every rank holds a tree bit for bit;
* :func:`stack_for_mesh` -- per-rank state (a replay buffer): each process
  holds its own, so this is this rank's own copy;
* :func:`make_dp_reinforce_step` / :func:`make_dp_dqn_step` /
  :func:`make_dp_acer_step` -- the local steps of ``runtime/vector.py`` built
  with the mesh's groups as ``axis_name``: each rank plays its own games
  (and keeps its own replay), and every optimizer update applies the
  :func:`~..utils.ops.pmean_fused` mean of the ranks' gradients, one flat
  all-reduce an update -- the gradient of the concatenated global minibatch,
  so the replicated params stay bit-identical on every rank.

Randomness is per rank, the counterpart of ``jax.random.split(key,
mesh.size)``: a step takes this rank's ``torch.Generator``
(:meth:`Mesh.generator` seeds one from ``(seed, index)``) or this rank's
injected randomness.  With noisy nets each rank draws its own noise: the synced
gradient averages ``mesh.size`` independent noise samples (JAX documents the
same variance reduction).
"""

from __future__ import annotations

import copy
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..agents.dqn import DQNConfig
from ..engine.state import EnvConfig
from ..nets import MLPSpec
from ..utils.device import resolve_device
from ..utils.ops import host_staged, leaves_with_paths

GAMES_AXIS = "games"
DCN_AXIS, ICI_AXIS = "dcn", "ici"


class Mesh:
    """This rank's view of a mesh of ranks.

    ``axis_names`` and ``shape`` (ranks along each axis), ``size``, ``ranks``
    (global ranks in mesh order), ``index`` (this rank's place in that order,
    ``None`` off the mesh), ``groups`` (this rank's process group along each
    axis), ``group`` (all the mesh's ranks) and ``device`` (this rank's
    ``torch.device``).
    """

    def __init__(self, axis_names, shape, ranks, groups, group, device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = int(np.prod(shape))
        self.ranks = list(ranks)
        rank = dist.get_rank()
        self.index = self.ranks.index(rank) if rank in self.ranks else None
        self.groups = groups
        self.group = group
        self.device = device

    def reduce_groups(self, axis=None) -> tuple:
        """The groups a reduce over ``axis`` (a name or a tuple of names;
        default every axis) runs through, innermost first."""
        axes = self.axis_names if axis is None else (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in the mesh's {self.axis_names}")
        return tuple(self.groups[a] for a in reversed(self.axis_names) if a in axes)

    def generator(self, seed: int) -> torch.Generator:
        """This rank's generator on its device, seeded from ``(seed, index)``."""
        words = np.random.SeedSequence([int(seed), int(self.index)]).generate_state(2, np.uint32)
        return torch.Generator(device=self.device).manual_seed(int(words[0]) << 31 | int(words[1]) >> 1)

    def __repr__(self):
        return f"Mesh({self.shape}, index={self.index}, device={self.device})"


def _require_process_group():
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a Mesh needs an initialized torch.distributed default process group "
                           "(dist.init_process_group, or parallel.launch.spawn)")


def _rank_device(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL process group reduces CUDA tensors: pass a CUDA device")
    return dev


def _group_of(ranks: Sequence[int]):
    """The process group of ``ranks`` (every rank of the world must call this,
    in the same order, members or not)."""
    if list(ranks) == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def make_mesh(num_devices: Optional[int] = None, axis: str = GAMES_AXIS, device="cuda") -> Mesh:
    """1-D mesh over the first ``num_devices`` ranks (default: all) with a
    named games axis.  Every rank of the world calls it."""
    dev = resolve_device(device)
    _require_process_group()
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if not 1 <= n <= world:
        raise ValueError(f"num_devices must be in [1, {world}], got {n}")
    group = _group_of(range(n))
    return Mesh((axis,), (n,), range(n), {axis: group}, group, _rank_device(dev))


def make_mesh_2level(num_slices: int, devices_per_slice: Optional[int] = None, device="cuda") -> Mesh:
    """2-level mesh with axes ``("dcn", "ici")`` over the first
    ``num_slices * devices_per_slice`` ranks, in row-major order: slice ``s``
    holds ranks ``s * devices_per_slice + i``.  Each rank's ``ici`` group is
    its slice, its ``dcn`` group the ranks of its in-slice index ``i`` in
    every slice.  Every rank of the world calls it."""
    dev = resolve_device(device)
    _require_process_group()
    world = dist.get_world_size()
    if devices_per_slice is None:
        if world % num_slices:
            raise ValueError(f"{world} ranks do not split into {num_slices} slices")
        devices_per_slice = world // num_slices
    S, D = int(num_slices), int(devices_per_slice)
    if S * D > world:
        raise ValueError(f"a {S} x {D} mesh needs {S * D} ranks, the world has {world}")
    rank = dist.get_rank()
    groups = {}
    for s in range(S):                      # every rank creates every group, in one order
        g = _group_of([s * D + i for i in range(D)])
        if rank // D == s and rank < S * D:
            groups[ICI_AXIS] = g
    for i in range(D):
        g = _group_of([s * D + i for s in range(S)])
        if rank % D == i and rank < S * D:
            groups[DCN_AXIS] = g
    group = _group_of(range(S * D))
    return Mesh((DCN_AXIS, ICI_AXIS), (S, D), range(S * D), groups, group, _rank_device(dev))


def mesh_axes(mesh: Mesh) -> tuple:
    """All mesh axis names as a tuple (the reduce spec for a full pmean)."""
    return tuple(mesh.axis_names)


class GameSharding:
    """This rank's contiguous slice of a games axis of a mesh's size."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def bounds(self, num_games: int):
        """``(lo, hi)`` of this rank's games; ``num_games`` must divide evenly."""
        n = self.mesh.size
        if num_games % n:
            raise ValueError(f"{num_games} games do not shard evenly over {n} ranks")
        per = num_games // n
        return self.mesh.index * per, (self.mesh.index + 1) * per

    def shard(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        lo, hi = self.bounds(x.shape[axis])
        return x.narrow(axis, lo, hi - lo)

    def gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Every rank's shard, concatenated along ``axis`` in mesh order."""
        group = self.mesh.group
        staged = host_staged(group, x.contiguous())
        parts = [torch.empty_like(staged) for _ in range(self.mesh.size)]
        dist.all_gather(parts, staged, group=group)
        return torch.cat(parts, dim=axis).to(x.device)


def game_sharding(mesh: Mesh, axis: str = GAMES_AXIS) -> GameSharding:
    """Shard the leading (games) axis over the whole mesh (every axis of a
    2-level mesh, as JAX's ``P((dcn, ici))``)."""
    return GameSharding(mesh)


class Replicated:
    """Trees that every rank of a mesh holds alike (JAX's replicated sharding:
    here each rank holds its own copy, so the check is all there is to do)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def check(self, tree) -> bool:
        """True when every rank holds ``tree`` bit for bit (a sha256 of its bytes)."""
        h = hashlib.sha256()
        for _, x in leaves_with_paths(tree):
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
        digests = [None] * self.mesh.size
        dist.all_gather_object(digests, h.hexdigest(), group=self.mesh.group)
        return len(set(digests)) == 1


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def stack_for_mesh(tree, mesh: Mesh):
    """Per-rank state for a DP step: JAX stacked one copy per device and
    sharded the stack; here each process holds its own, so this returns this
    rank's own deep copy of ``tree``."""
    return copy.deepcopy(tree)


def _default_axis(mesh: Mesh, axis):
    if axis is None:
        return mesh_axes(mesh) if len(mesh.axis_names) > 1 else mesh.axis_names[0]
    return axis


def make_dp_reinforce_step(cfg: EnvConfig, spec: MLPSpec, optimizer, games_per_device: int, mesh: Mesh,
                           axis=None, **reinforce_kwargs):
    """Data-parallel REINFORCE self-play step over a mesh.

    ``(params, opt_state, rng) -> (params, opt_state, metrics)``: ``rng`` is
    this rank's ``torch.Generator`` or ``RolloutRandomness``.
    Each rank plays ``games_per_device`` games on ``mesh.device``; the
    gradients, the loss and the mean score are averaged over ``axis``
    (default every axis) in one all-reduce, so the update is the same
    everywhere.
    """
    from ..runtime.vector import make_reinforce_train_step

    groups = mesh.reduce_groups(_default_axis(mesh, axis))
    reinforce_kwargs.setdefault("device", mesh.device)
    local = make_reinforce_train_step(cfg, spec, optimizer, games_per_device, axis_name=groups,
                                      **reinforce_kwargs)

    def step(params, opt_state, rng):
        return local(params, opt_state, rng)

    return step


def make_dp_dqn_step(cfg: EnvConfig, dqn_cfg: DQNConfig, optimizer, games_per_device: int, mesh: Mesh,
                     axis=None, **dqn_kwargs):
    """Data-parallel DQN self-play cycle over a mesh.

    ``(params, target_params, opt_state, buf, rng, eps, step0=0) -> (params,
    target_params, opt_state, buf, metrics)``: ``buf`` is this rank's own
    replay (:func:`stack_for_mesh`), ``rng`` this rank's generator or
    ``CycleRandomness``.  Every rank plays its own games, fills
    its own buffer and samples its own minibatches, but each Bellman update
    applies the mean of the ranks' gradients (one all-reduce an update, the
    loss riding along), and the cycle's mean score is averaged once more at
    its end.  Every mode of the local cycle (engine, ``kernel_act_rollout``,
    ``kernel_insert``) works.
    """
    from ..runtime.vector import make_dqn_selfplay_step

    groups = mesh.reduce_groups(_default_axis(mesh, axis))
    dqn_kwargs.setdefault("device", mesh.device)
    inner = make_dqn_selfplay_step(cfg, dqn_cfg, optimizer, games_per_device, axis_name=groups, **dqn_kwargs)

    def cycle(params, target_params, opt_state, buf, rng, eps, step0: int = 0):
        return inner(params, target_params, opt_state, buf, rng, eps, step0)

    return cycle


def make_dp_acer_step(cfg: EnvConfig, spec: MLPSpec, optimizer, games_per_device: int, mesh: Mesh,
                      axis=None, **acer_kwargs):
    """Data-parallel ACER self-play cycle over a mesh.

    ``(params, opt_state, buf, rng) -> (params, opt_state, buf, metrics)``:
    ``buf`` this rank's own sequence buffer, ``rng`` this rank's generator or
    ``AcerRandomness``.  Both the on- and the off-policy update
    apply the ranks' mean gradient, and the mean score is averaged at the end.
    """
    from ..runtime.vector import make_acer_selfplay_step

    groups = mesh.reduce_groups(_default_axis(mesh, axis))
    acer_kwargs.setdefault("device", mesh.device)
    inner = make_acer_selfplay_step(cfg, spec, optimizer, games_per_device, axis_name=groups, **acer_kwargs)

    def cycle(params, opt_state, buf, rng):
        return inner(params, opt_state, buf, rng)

    return cycle
