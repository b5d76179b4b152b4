"""Data-parallel checks, run by every rank of a ``torch.distributed`` world.

:func:`run_checks` is the body of each rank (``parallel.launch.spawn(run_checks,
world, inputs, device)``); the CPU tests spawn it over gloo ranks and
``chip_smoke.py`` over two gloo ranks sharing the card.  It holds the
properties of the JAX package's ``tests/test_dp_sync.py`` and more, on meshes
of 1, 2 and (with four ranks) 4 ranks and a 2-level mesh:

* ``learn``: a DQN learn step (``make_learn_step(..., axis_name=...)``) with
  the global minibatch sharded over n ranks, beside the plain step on the
  whole minibatch; ``acer`` the same for ACER's train step;
* ``replicated``: after each DP step the params are bit-identical on every
  rank of its mesh (a sha256 of their bytes);
* ``rerun``: a DP DQN cycle and a DP REINFORCE step, run twice from one
  state, agree bit for bit;
* ``size1``: on a 1-rank mesh the DP REINFORCE step, DQN cycle and ACER cycle
  equal the plain ones bit for bit;
* ``reinforce_steps``: the DP REINFORCE step on each 1-D mesh over injected
  draws (one a rank a step, e.g. JAX's per-device keys replayed), from given
  params, under SGD and Adam: each step's loss, mean score and params;
* ``pmean``: :func:`~..utils.ops.pmean_fused` of a tree equals the per-leaf
  means (one ``all_reduce`` a leaf), and is the tree itself on one rank;
  ``allreduce_ms`` times it at ``allreduce_floats`` (given) on each mesh, and
  ``cycle_s`` holds each DP DQN cycle's seconds;
* ``block``: a device block sharded over each mesh plays the same games as
  the block function on the whole block's noise (``fn``), and
  ``tournament`` a tournament's ``play_device_block`` over each mesh ends
  with the same ELO.

Inputs arrive as numpy (params as JAX-layout trees, batches as dicts), so
the caller can compute references anywhere; results go back as numpy.  Rank 0
returns everything it computed, with ``launches``, its process's kernel
launches; the other ranks return ``None``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..agents.acer import make_acer_train_step
from ..agents.dqn import Adam, DQNConfig, Sgd, make_learn_step, q_network_spec, tree_map
from ..buffers import per_init, per_init_kd, seq_init
from ..engine import EnvConfig
from ..nets import MLPSpec, mlp_init, params_from_jax, params_to_numpy
from ..ops import _build
from ..ops.act_rollout_kernel import S_PAD, SCAL_ROWS
from ..parallel import (make_dp_acer_step, make_dp_dqn_step, make_dp_reinforce_step, make_mesh, make_mesh_2level,
                        replicated, stack_for_mesh)
from ..utils.device import synchronize
from ..utils.ops import ALLREDUCES
from .vector import (RolloutRandomness, acer_sequence_example, dqn_replay_example, make_acer_selfplay_step,
                     make_dqn_selfplay_step, make_reinforce_train_step)

STATE = 47


def _tensors(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def _numpy_adam(state) -> dict:
    return {"count": state.count, "mu": params_to_numpy(state.mu), "nu": params_to_numpy(state.nu)}


def _dqn_learn(case: dict, mesh, device):
    """One DQN learn step on this rank's shard of the case's global batch
    (``mesh=None``: the plain step on all of it)."""
    cfg = DQNConfig(**case["cfg"])
    spec = q_network_spec(cfg, STATE, 104)
    params = params_from_jax(case["params"], device)
    target = params_from_jax(case["target"], device) if cfg.double else None
    opt = Adam(1e-3)
    batch = _tensors(case["batch"], device)
    groups = None
    if mesh is not None:
        groups = mesh.reduce_groups()
        n = next(iter(batch.values())).shape[0] // mesh.size
        batch = {k: v[mesh.index * n:(mesh.index + 1) * n] for k, v in batch.items()}
    step = make_learn_step(cfg, spec, opt, gamma=0.99, axis_name=groups)
    p, t, o, loss, _, _ = step(params, target, opt.init(params), batch, True)
    return {"params": params_to_numpy(p), "target": params_to_numpy(t) if t is not None else None,
            "adam": _numpy_adam(o), "loss": float(loss)}, p


def _acer_train(case: dict, mesh, device):
    spec = MLPSpec(input_size=1 + STATE, hidden_sizes=(16,), head_sizes=(1, 1))
    params = params_from_jax(case["params"], device)
    batch = _tensors(case["batch"], device)
    groups = None
    if mesh is not None:
        groups = mesh.reduce_groups()
        n = batch["length"].shape[0] // mesh.size
        batch = {k: v[mesh.index * n:(mesh.index + 1) * n] for k, v in batch.items()}
    opt = Sgd(1e-2)
    p, _, losses = make_acer_train_step(spec, opt, axis_name=groups)(params, opt.init(params), batch)
    return {"params": params_to_numpy(p), "losses": [float(x) for x in losses]}, p


def _meshes(world: int, device):
    """``{name: mesh}`` over the world: 1, 2 and 4 ranks, and 2 x (world/2) two-level."""
    meshes = {f"n{n}": make_mesh(n, device=device) for n in (1, 2, 4) if n <= world}
    if world >= 2 and world % 2 == 0:
        meshes[f"2x{world // 2}"] = make_mesh_2level(2, world // 2, device=device)
    return meshes


def _reinforce(cfg, games, device, mesh=None, hidden=(16,)):
    spec = MLPSpec(input_size=cfg.state_length + 1, hidden_sizes=tuple(hidden), head_sizes=(1,))
    params = mlp_init(torch.Generator(device=device).manual_seed(5), spec, device)
    opt = Adam(1e-3)
    if mesh is None:
        return make_reinforce_train_step(cfg, spec, opt, games, device=device), params, opt.init(params)
    return make_dp_reinforce_step(cfg, spec, opt, games, mesh), params, opt.init(params)


def _reinforce_steps(cfg, case: dict, mesh, device) -> dict:
    """The DP REINFORCE step over ``mesh`` from the case's params (JAX layout), on
    the case's draws for this mesh's size (``[step][index] -> {"gumbel",
    "decks"}``), under each optimizer of ``case["lr"]``: per step the loss, the
    mean score and the params, and whether the ranks end bit-identical."""
    spec = MLPSpec(input_size=cfg.state_length + 1, hidden_sizes=tuple(case["hidden"]), head_sizes=(1,))
    out = {}
    for name, lr in case["lr"].items():
        opt = Sgd(lr) if name == "sgd" else Adam(lr)
        params = params_from_jax(case["params"], device)
        state = opt.init(params)
        step = make_dp_reinforce_step(cfg, spec, opt, case["games"], mesh)
        steps = []
        for draws in case["randomness"][mesh.size]:
            rnd = RolloutRandomness(**_tensors(draws[mesh.index], device))
            params, state, m = step(params, state, rnd)
            steps.append({"loss": float(m["loss"]), "mean_score": float(m["mean_score"]),
                          "params": params_to_numpy(params)})
        out[name] = {"steps": steps, "replicated": replicated(mesh).check(params)}
    return out


def _dqn_cycle(cfg, case, device, mesh=None):
    dqn_cfg = DQNConfig(**case["cfg"])
    spec = q_network_spec(dqn_cfg, cfg.state_length, cfg.num_actions)
    params = mlp_init(torch.Generator(device=device).manual_seed(9), spec, device)
    target = tree_map(torch.clone, params) if dqn_cfg.double else None
    opt = Adam(1e-3)
    mode = case.get("mode", "engine")
    kw = dict(learn_iters=case["learn_iters"], kernel_act_rollout=mode == "kernel", kernel_insert=mode == "insert")
    if mode == "insert":
        buf = per_init_kd(case["capacity"], S_PAD, SCAL_ROWS, device=device)
    else:
        buf = per_init(case["capacity"], dqn_replay_example(cfg), device=device)
    if mesh is None:
        cycle = make_dqn_selfplay_step(cfg, dqn_cfg, opt, case["games"], device=device, **kw)
    else:
        cycle = make_dp_dqn_step(cfg, dqn_cfg, opt, case["games"], mesh, **kw)
        buf = stack_for_mesh(buf, mesh)
    return cycle, params, target, opt.init(params), buf


def _acer_cycle(cfg, games, device, mesh=None):
    spec = MLPSpec(input_size=1 + cfg.state_length, hidden_sizes=(16,), head_sizes=(1, 1))
    params = mlp_init(torch.Generator(device=device).manual_seed(3), spec, device)
    opt = Adam(1e-3)
    buf = seq_init(256, cfg.max_turns, acer_sequence_example(cfg), device=device)
    kw = dict(minibatch=8, on_policy_sequences=16)
    if mesh is None:
        return make_acer_selfplay_step(cfg, spec, opt, games, device=device, **kw), params, opt.init(params), buf
    return make_dp_acer_step(cfg, spec, opt, games, mesh, **kw), params, opt.init(params), stack_for_mesh(buf, mesh)


def trees_equal(a, b) -> bool:
    """Two trees (dicts, lists, tuples, dataclasses, tensors) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    if dataclasses.is_dataclass(a):
        return all(trees_equal(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    return a == b


def _pmean_agrees(mesh, device) -> dict:
    """pmean_fused against one all_reduce a leaf, on rank-dependent values:
    ``max_err`` (the sums may add in another order: gloo's ring chunks the
    one flat buffer differently from the leaves), ``identity`` (one rank
    gives the tree bit for bit, no group the tree itself)."""
    import torch.distributed as dist

    from ..utils.ops import pmean_fused

    g = torch.Generator().manual_seed(100 + mesh.index)
    draw = lambda *shape: torch.randn(shape, generator=g).to(device)
    tree = ({"w": draw(3, 5), "b": [draw(5)]}, draw())
    fused = pmean_fused(tree, mesh.reduce_groups())
    err = 0.0
    for x, y in zip((tree[0]["w"], tree[0]["b"][0], tree[1]), (fused[0]["w"], fused[0]["b"][0], fused[1])):
        ref = x.clone()
        for group in mesh.reduce_groups():
            dist.all_reduce(ref, group=group)
        err = max(err, float((ref / mesh.size - y).abs().max()))
    identity = pmean_fused(tree, None) is tree and (mesh.size > 1 or trees_equal(fused, tree))
    return {"max_err": err, "identity": identity}


def allreduce_ms(mesh, device, floats: int, reps: int = 20) -> float:
    """Median ms of one pmean_fused of a ``floats``-long gradient and a loss
    (the all-reduce an update adds), from the host's call to the result on the device."""
    from ..utils.ops import pmean_fused

    tree = ({"w": torch.ones(floats - 1, device=device)}, torch.ones((), device=device))
    times = []
    for i in range(reps + 3):
        synchronize(device)
        t0 = time.perf_counter()
        pmean_fused(tree, mesh.reduce_groups())
        synchronize(device)
        times.append(time.perf_counter() - t0)
    return 1e3 * sorted(times[3:])[reps // 2]


def _tournament_elos(mesh, device, games: int, seed: int = 7) -> dict:
    from ..agents.mcs import MCSAgent
    from ..agents.random_agent import DrunkHamster
    from ..tournament import Tournament

    np.random.seed(seed)
    t = Tournament(min_players=2, max_players=2, device=device)
    t.add_player("random", DrunkHamster(seed=1, device=device))
    t.add_player("mcs", MCSAgent(seed=2, mc_max=8, mc_per_card=2, device=device))
    t.play_device_block(games, mesh=mesh)
    return {name: [float(e) for e in t.elos[name]] for name in ("random", "mcs")}


def _block_scores(mesh, device, games: int, seed: int = 123):
    """A device block of random and MCS seats sharded over ``mesh``, on one
    ``np.random`` state; ``mesh=None``: the block function itself on the
    whole block's noise, drawn as a mesh session draws it."""
    from ..agents.mcs import MCSAgent
    from ..agents.random_agent import DrunkHamster
    from .device_tournament import DeviceBlockSession, draw_block_noise, turn_rounds

    np.random.seed(seed)
    lineups = [[DrunkHamster(seed=1, device=device), MCSAgent(seed=2, mc_max=8, mc_per_card=2, device=device)]
               for _ in range(games)]
    session = DeviceBlockSession(lineups, mesh=mesh, device=device)
    if mesh is not None:
        return np.stack(session.play())
    inputs = session.assemble()
    gen = torch.Generator(device=session.device).manual_seed(int(np.random.randint(0, 2**31 - 1)))
    rounds = turn_rounds(session.cfg, inputs.kinds, inputs.mc_maxes, inputs.mc_pers, inputs.K)
    noise = draw_block_noise(gen, session.cfg, games, inputs.K, rounds, session.slots)
    scores, _, _ = session.block_fn(inputs)(inputs.params, inputs.lparams, inputs.kinds, inputs.mc_maxes,
                                            inputs.mc_pers, inputs.c_pucts, inputs.epses, noise)
    return scores.cpu().numpy()


def run_checks(rank: int, world: int, inputs: dict, device="cuda"):
    """Every check above on this rank; rank 0's results (numpy), else None."""
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = EnvConfig(4)
    hidden = inputs.get("reinforce_hidden", (16,))
    meshes = _meshes(world, device)
    members = {name: m for name, m in meshes.items() if m.index is not None}
    out = {"learn": {}, "acer": {}, "replicated": {}, "rerun": {}, "size1": {}, "block": {}, "allreduces": {}}

    # N-rank updates against the plain one on the global batch.
    for name, case in inputs.get("dqn_learn", {}).items():
        out["learn"][(name, "plain")] = _dqn_learn(case, None, device)[0]
        for mname, mesh in members.items():
            res, p = _dqn_learn(case, mesh, device)
            out["learn"][(name, mname)] = res
            out["replicated"][f"learn_{name}_{mname}"] = replicated(mesh).check(p)
    if "acer_train" in inputs:
        out["acer"]["plain"] = _acer_train(inputs["acer_train"], None, device)[0]
        for mname, mesh in members.items():
            res, p = _acer_train(inputs["acer_train"], mesh, device)
            out["acer"][mname] = res
            out["replicated"][f"acer_{mname}"] = replicated(mesh).check(p)

    # DP cycles: replicated params, and a rerun from one state agrees bit for bit.
    cycle_case = inputs.get("dqn_cycle")
    for mname, mesh in members.items():
        if cycle_case is not None:
            cycle, params, target, opt, buf = _dqn_cycle(cfg, cycle_case, device, mesh)
            runs = []
            for _ in range(2):
                before, t0 = ALLREDUCES["calls"], time.perf_counter()
                runs.append(cycle(params, target, opt, stack_for_mesh(buf, mesh), mesh.generator(10), 0.3))
                synchronize(device)
                out["allreduces"][f"dqn_{mname}"] = ALLREDUCES["calls"] - before
                out.setdefault("cycle_s", {})[f"dqn_{mname}"] = time.perf_counter() - t0
            out["replicated"][f"dqn_cycle_{mname}"] = replicated(mesh).check(runs[0][0])
            out["rerun"][f"dqn_cycle_{mname}"] = trees_equal(runs[0][:3], runs[1][:3])
        if "reinforce_games" in inputs:
            step, params, opt = _reinforce(cfg, inputs["reinforce_games"], device, mesh, hidden)
            runs = [step(params, opt, mesh.generator(11)) for _ in range(2)]
            out["replicated"][f"reinforce_{mname}"] = replicated(mesh).check(runs[0][0])
            out["rerun"][f"reinforce_{mname}"] = trees_equal(runs[0], runs[1])

    # The DP REINFORCE step on injected draws, for the caller's reference (JAX's shard_map step).
    if "reinforce_steps" in inputs:
        for mname, mesh in members.items():
            if len(mesh.axis_names) == 1 and mesh.size in inputs["reinforce_steps"]["randomness"]:
                out.setdefault("reinforce_steps", {})[mname] = _reinforce_steps(cfg, inputs["reinforce_steps"],
                                                                               mesh, device)

    # A 1-rank mesh is the plain step, bit for bit.
    if "n1" in members:
        mesh = members["n1"]
        if "reinforce_games" in inputs:
            plain = _reinforce(cfg, inputs["reinforce_games"], device, hidden=hidden)
            dp = _reinforce(cfg, inputs["reinforce_games"], device, mesh, hidden)
            out["size1"]["reinforce"] = trees_equal(plain[0](*plain[1:], mesh.generator(12)),
                                               dp[0](*dp[1:], mesh.generator(12)))
        if cycle_case is not None:
            plain, dp = _dqn_cycle(cfg, cycle_case, device), _dqn_cycle(cfg, cycle_case, device, mesh)
            a = plain[0](*plain[1:], mesh.generator(13), 0.3)
            b = dp[0](*dp[1:], mesh.generator(13), 0.3)
            out["size1"]["dqn"] = trees_equal(a[:3] + (a[4],), b[:3] + (b[4],))
        if "acer_games" in inputs:
            plain, dp = _acer_cycle(cfg, inputs["acer_games"], device), _acer_cycle(cfg, inputs["acer_games"],
                                                                                    device, mesh)
            a = plain[0](*plain[1:], mesh.generator(14))
            b = dp[0](*dp[1:], mesh.generator(14))
            out["size1"]["acer"] = trees_equal((a[0], a[3]), (b[0], b[3]))

    # The sharded device block plays the same games on every mesh.
    if "block_games" in inputs and rank == 0:
        out["block"]["fn"] = _block_scores(None, device, inputs["block_games"])
    for mname, mesh in members.items():
        out.setdefault("pmean", {})[mname] = _pmean_agrees(mesh, device)
        if "allreduce_floats" in inputs:
            out.setdefault("allreduce_ms", {})[mname] = allreduce_ms(mesh, device, inputs["allreduce_floats"])
        if len(mesh.axis_names) == 1 and "block_games" in inputs:
            out["block"][mname] = _block_scores(mesh, device, inputs["block_games"])
            out.setdefault("tournament", {})[mname] = _tournament_elos(mesh, device, inputs["block_games"])
    out["launches"] = dict(_build.LAUNCHES)        # this rank's kernel launches, every check included
    return out if rank == 0 else None
