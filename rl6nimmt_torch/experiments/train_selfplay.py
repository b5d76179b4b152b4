"""Large-scale self-play training on the card (port of ``experiments/train_selfplay.py``).

Trains the REINFORCE, ACER or DQN-lattice learner on thousands of parallel
games an update with the ported steps of ``runtime/vector.py``.  ``--dp``
trains data-parallel (``parallel.make_dp_*_step``): the ranks come from
``RANK``/``WORLD_SIZE`` when a launcher such as ``torchrun`` set them, else
the script spawns ``--world`` ranks itself; ``--games`` is split over them.
``--save`` writes the final params as npz (``utils.save_params``, the JAX
package's key names); under ``--dp`` rank 0 writes.

    python -m rl6nimmt_torch.experiments.train_selfplay --algo reinforce --games 4096 --steps 100
    python -m rl6nimmt_torch.experiments.train_selfplay --algo dqn --games 1024 --steps 200 --dp --world 2 \\
        --backend gloo
"""

from __future__ import annotations

import argparse
import os
import time


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--algo", choices=["reinforce", "dqn", "acer"], default="reinforce")
    parser.add_argument("--games", type=int, default=4096, help="parallel games per step (over all ranks)")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--players", type=int, default=4)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--hidden", type=int, nargs="+", default=[100, 100])
    parser.add_argument("--buffer", type=int, default=1 << 18)
    parser.add_argument("--minibatch", type=int, default=1024)
    parser.add_argument("--learn-iters", type=int, default=10)
    parser.add_argument("--dp", action="store_true", help="data-parallel over --world ranks")
    parser.add_argument("--world", type=int, default=None,
                        help="ranks --dp spawns (default: one a card; required on the CPU)")
    parser.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                        help="--dp's process-group backend (default: nccl on the card, gloo on the CPU)")
    parser.add_argument("--save", type=str, default=None, help="npz path for params")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def train(args: argparse.Namespace, mesh=None):
    """Run the training loop; returns the final params (on this rank's device)."""
    import numpy as np
    import torch

    from ..agents.dqn import Adam, DQNConfig, q_network_spec, tree_map
    from ..buffers import per_init, seq_init
    from ..engine import EnvConfig
    from ..nets import MLPSpec, mlp_init
    from ..utils import save_params
    from ..utils.device import resolve_device
    from ..runtime import vector

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    ranks = mesh.size if mesh is not None else 1
    if args.games % ranks:
        raise ValueError(f"--games {args.games} does not split over {ranks} ranks")
    games = args.games // ranks
    lead = mesh is None or mesh.index == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = EnvConfig(num_players=args.players)
    optimizer = Adam(args.lr)
    init = torch.Generator(device=dev).manual_seed(args.seed)
    gen = mesh.generator(args.seed + 1) if mesh is not None else torch.Generator(device=dev).manual_seed(
        args.seed + 1)
    start = time.perf_counter()

    if args.algo == "reinforce":
        spec = MLPSpec(input_size=cfg.state_length + 1, hidden_sizes=tuple(args.hidden), head_sizes=(1,))
        params = mlp_init(init, spec, dev)
        opt_state = optimizer.init(params)
        if mesh is not None:
            from ..parallel import make_dp_reinforce_step

            step = make_dp_reinforce_step(cfg, spec, optimizer, games, mesh)
        else:
            step = vector.make_reinforce_train_step(cfg, spec, optimizer, games, device=dev)
        for i in range(args.steps):
            params, opt_state, metrics = step(params, opt_state, gen)
            if i % 10 == 0 or i == args.steps - 1:
                rate = args.games * cfg.num_players * (i + 1) / (time.perf_counter() - start)
                say(f"step {i:>4}  loss {float(metrics['loss']):>10.3f}  mean_score "
                    f"{float(metrics['mean_score']):>7.3f}  episodes/s {rate:,.0f}")

    elif args.algo == "acer":
        spec = MLPSpec(input_size=1 + cfg.state_length, hidden_sizes=tuple(args.hidden), head_sizes=(1, 1))
        params = mlp_init(init, spec, dev)
        opt_state = optimizer.init(params)
        buf = seq_init(args.buffer, cfg.max_turns, vector.acer_sequence_example(cfg), device=dev)
        if mesh is not None:
            from ..parallel import make_dp_acer_step, stack_for_mesh

            buf = stack_for_mesh(buf, mesh)
            cycle = make_dp_acer_step(cfg, spec, optimizer, games, mesh, minibatch=args.minibatch)
        else:
            cycle = vector.make_acer_selfplay_step(cfg, spec, optimizer, games, minibatch=args.minibatch,
                                                   device=dev)
        for i in range(args.steps):
            params, opt_state, buf, metrics = cycle(params, opt_state, buf, gen)
            if i % 10 == 0 or i == args.steps - 1:
                rate = args.games * cfg.num_players * (i + 1) / (time.perf_counter() - start)
                say(f"cycle {i:>4}  actor {float(metrics['actor_loss']):>9.4f}  critic "
                    f"{float(metrics['critic_loss']):>9.4f}  mean_score {float(metrics['mean_score']):>7.3f}  "
                    f"episodes/s {rate:,.0f}")

    else:
        dqn_cfg = DQNConfig(double=True, dueling=True, noisy=True, per=True, n_steps=3,
                            hidden_sizes=tuple(args.hidden), minibatch=args.minibatch)
        spec = q_network_spec(dqn_cfg, cfg.state_length, cfg.num_actions)
        params = mlp_init(init, spec, dev)
        target = tree_map(torch.clone, params)
        opt_state = optimizer.init(params)
        buf = per_init(args.buffer, vector.dqn_replay_example(cfg), device=dev)
        if mesh is not None:
            from ..parallel import make_dp_dqn_step, stack_for_mesh

            buf = stack_for_mesh(buf, mesh)
            cycle = make_dp_dqn_step(cfg, dqn_cfg, optimizer, games, mesh, learn_iters=args.learn_iters)
        else:
            cycle = vector.make_dqn_selfplay_step(cfg, dqn_cfg, optimizer, games, learn_iters=args.learn_iters,
                                                  device=dev)
        for i in range(args.steps):
            eps = max(np.exp(-0.0025 * i), 0.05)
            params, target, opt_state, buf, metrics = cycle(params, target, opt_state, buf, gen, eps)
            if i % 10 == 0 or i == args.steps - 1:
                rate = args.games * (i + 1) / (time.perf_counter() - start)
                say(f"cycle {i:>4}  loss {float(metrics['loss']):>10.4f}  mean_score "
                    f"{float(metrics['mean_score']):>7.3f}  games/s {rate:,.0f}  eps {eps:.3f}")

    if args.save and lead:
        save_params(args.save, params)
        say(f"saved params to {args.save}")
    return params


def _rank(rank: int, world: int, args: argparse.Namespace):
    from ..nets import params_to_numpy
    from ..parallel import make_mesh

    params = train(args, make_mesh(device=args.device))
    return params_to_numpy(params) if rank == 0 else None


def run(argv=None):
    """Parse ``argv`` and train; returns the final params (rank 0's, as numpy,
    when ``--dp`` spawned the ranks)."""
    import torch

    from ..parallel.launch import init_from_env, spawn
    from ..utils.device import resolve_device

    args = parse(argv)
    dev = resolve_device(args.device)
    if not args.dp:
        return train(args)
    backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        from ..parallel import make_mesh

        init_from_env(backend)
        try:
            return train(args, make_mesh(device=args.device))
        finally:
            dist.destroy_process_group()
    world = args.world or (torch.cuda.device_count() if dev.type == "cuda" else None)
    if not world:
        raise ValueError("--dp on the CPU needs --world (the ranks to spawn)")
    return spawn(_rank, world, args, backend=backend)[0]


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
