"""Multi-process data-parallel training over ``torch.distributed`` (port of
``experiments/multiprocess_dp.py``).

Spawns ``--num-processes`` ranks (gloo by default, ``--backend nccl`` for
one card a rank), wires them into one mesh (``parallel.make_mesh``) and runs
``--steps`` DP REINFORCE steps (``--algo dqn``: DP DQN cycles) on
``--games`` games a step split evenly over the ranks.  Each rank plays its
contiguous slice of the step's games; the decks and Gumbel noise of all of
them are drawn with numpy from ``--seed`` on every rank, so a run over N
ranks plays the same games as a run over one rank (REINFORCE; a DQN rank
keeps its own replay and generator, so DQN runs agree only at one layout).

Checked per run: after the last step the params are byte-identical on every
rank (a sha256 the launcher compares).  Prints one line per rank, then one
JSON line: ``params_replicated_across_processes``, ``metrics``,
``params_l1``, ``global_devices`` (the ranks), ``ms_per_update`` and
``env_steps_per_s`` (ranks sharing one host's cores or one card measure the
code path, not scaling: ``shared_host``).

    python -m rl6nimmt_torch.experiments.multiprocess_dp --num-processes 2 --device cpu
    python -m rl6nimmt_torch.experiments.multiprocess_dp --num-processes 1 --backend nccl
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch


def step_randomness(cfg, games: int, seed: int, step: int, device):
    """The ``RolloutRandomness`` of one step's ``games`` games (decks and Gumbel
    noise from numpy), on ``device``."""
    from ..runtime.vector import RolloutRandomness

    rng = np.random.default_rng([seed, step])
    decks = np.argsort(rng.random((games, cfg.num_cards)), axis=1)
    gumbel = rng.gumbel(size=(cfg.max_turns, games, cfg.num_players, cfg.hand_size)).astype(np.float32)
    return RolloutRandomness(gumbel=torch.as_tensor(gumbel, device=device),
                             decks=torch.as_tensor(decks, dtype=torch.int32, device=device))


def _shard(rnd, mesh):
    from ..parallel import game_sharding
    from ..runtime.vector import RolloutRandomness

    sharding = game_sharding(mesh)
    return RolloutRandomness(gumbel=sharding.shard(rnd.gumbel, axis=1), decks=sharding.shard(rnd.decks))


def worker(rank: int, world: int, args: dict) -> dict:
    """One rank: ``args["steps"]`` DP steps after a first (warm-up) one."""
    from ..agents.dqn import Adam, DQNConfig, q_network_spec, tree_leaves, tree_map
    from ..buffers import per_init
    from ..engine import EnvConfig
    from ..nets import MLPSpec, mlp_init
    from ..parallel import make_dp_dqn_step, make_dp_reinforce_step, make_mesh, stack_for_mesh
    from ..runtime.vector import dqn_replay_example

    cfg = EnvConfig(num_players=4)
    mesh = make_mesh(device=args["device"])
    dev = mesh.device
    games = args["games"] // mesh.size
    optimizer = Adam(1e-3)
    init = torch.Generator(device=dev).manual_seed(args["seed"])
    if args["algo"] == "dqn":
        dqn_cfg = DQNConfig(double=True, dueling=True, per=True, n_steps=10, hidden_sizes=(64,), minibatch=64)
        spec = q_network_spec(dqn_cfg, cfg.state_length, cfg.num_actions)
        params = mlp_init(init, spec, dev)
        state = [params, tree_map(torch.clone, params), optimizer.init(params)]
        cap = max(8192, 2 * games * cfg.num_players * cfg.max_turns)
        buf = stack_for_mesh(per_init(cap, dqn_replay_example(cfg), device=dev), mesh)
        cycle = make_dp_dqn_step(cfg, dqn_cfg, optimizer, games, mesh, learn_iters=8)
        gen = mesh.generator(args["seed"] + 1)

        def one(i):
            nonlocal buf
            *out, buf, m = cycle(*state, buf, gen, 0.1)
            state[:] = out
            return m
    else:
        spec = MLPSpec(input_size=cfg.state_length + 1, head_sizes=(1,))
        params = mlp_init(init, spec, dev)
        state = [params, optimizer.init(params)]
        step = make_dp_reinforce_step(cfg, spec, optimizer, games, mesh)

        def one(i):
            *out, m = step(*state, _shard(step_randomness(cfg, args["games"], args["seed"], i, dev), mesh))
            state[:] = out
            return m

    one(0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    start = time.perf_counter()
    for i in range(1, args["steps"] + 1):
        metrics = one(i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - start) / max(args["steps"], 1)
    digest, l1 = hashlib.sha256(), 0.0
    for leaf in tree_leaves(state[0]):
        host = leaf.detach().cpu().contiguous().numpy()
        digest.update(host.tobytes())
        l1 += float(np.abs(host).astype(np.float64).sum())
    return {"process_id": rank, "global_devices": world, "device": str(dev), "algo": args["algo"],
            "ms_per_update": dt * 1e3, "env_steps_per_s": args["games"] * cfg.max_turns / dt,
            "params_digest": digest.hexdigest(), "params_l1": l1,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def launch(args) -> dict:
    from ..parallel.launch import spawn
    from ..utils.device import resolve_device

    resolve_device(args.device)
    if args.games % args.num_processes:
        raise ValueError(f"--games {args.games} does not split over {args.num_processes} processes")
    results = spawn(worker, args.num_processes, vars(args), backend=args.backend, timeout=args.timeout)
    for r in results:
        print(f"process {r['process_id']}: {r['device']}, {r['ms_per_update']:.1f} ms/update, "
              f"digest {r['params_digest'][:12]}")
    replicated = len({r["params_digest"] for r in results}) == 1
    return {"ok": replicated, "algo": args.algo, "backend": args.backend, "num_processes": args.num_processes,
            "global_devices": results[0]["global_devices"], "params_replicated_across_processes": replicated,
            "ms_per_update": max(r["ms_per_update"] for r in results),
            "env_steps_per_s": min(r["env_steps_per_s"] for r in results), "shared_host": True,
            "params_digest": results[0]["params_digest"], "params_l1": results[0]["params_l1"],
            "metrics": results[0]["metrics"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num-processes", type=int, default=2)
    parser.add_argument("--games", type=int, default=128, help="games a step, over all processes")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--algo", choices=("reinforce", "dqn"), default="reinforce")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args(argv)
    summary = launch(args)
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
