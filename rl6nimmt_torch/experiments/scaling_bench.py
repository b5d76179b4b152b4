"""Weak-scaling benchmark of the data-parallel REINFORCE step (port of
``experiments/scaling_bench.py``).

Measures updates/s of the DP REINFORCE step at fixed games a device while the
world grows 1, 2, 4, ... ranks over the devices available, and reports
parallel efficiency (rate_N / (N * rate_1)).  Each row is one world of N
ranks (``parallel/launch.py`` ``spawn``): every rank builds
``make_mesh(num_devices=N)`` and ``make_dp_reinforce_step``, plays one warm-up
step outside the timed window, then ``--steps`` steps on its own generator,
ended by ``torch.cuda.synchronize()`` on the card; rank 0's host clock gives
the row.  After the last step every rank hashes its params (sha256) and the
launcher requires the hashes to agree.

The devices available are ``torch.cuda.device_count()`` under NCCL (one card
a rank) and ``--max-devices`` under gloo (the counterpart of XLA's forced host
device count).  Ranks that share cores or a card -- every gloo row, and more
ranks than cards -- validate the code path only: such rows are labelled so
and ``virtual_mesh`` is true, as the JAX script labels a virtual CPU mesh.
Nothing switches backend or device by itself: NCCL without a card raises.

    python -m rl6nimmt_torch.experiments.scaling_bench --games-per-device 256 --steps 20
    python -m rl6nimmt_torch.experiments.scaling_bench --backend gloo --max-devices 2
    python -m rl6nimmt_torch.experiments.scaling_bench --device cpu --backend gloo --max-devices 2
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import torch

SIZES = (1, 2, 4, 8, 16, 32)


def device_counts(n_total: int) -> list:
    """The world sizes of the sweep: the JAX script's sizes up to ``n_total``."""
    return [n for n in SIZES if n <= n_total]


def worker(rank: int, world: int, args: dict) -> dict:
    """One rank of a world of ``world``: a warm-up step, then ``args["steps"]``
    timed DP steps; its seconds an update, params hash, last metrics and its
    process's kernel launches (warm-up included)."""
    from ..agents.dqn import Adam, tree_leaves
    from ..engine import EnvConfig
    from ..nets import MLPSpec, mlp_init
    from ..ops import _build
    from ..parallel import make_dp_reinforce_step, make_mesh
    from ..utils.device import synchronize

    _build.reset_launches()
    cfg = EnvConfig(num_players=4)
    spec = MLPSpec(input_size=cfg.state_length + 1, head_sizes=(1,))
    mesh = make_mesh(num_devices=world, device=args["device"])
    dev = mesh.device
    params = mlp_init(torch.Generator(device=dev).manual_seed(args["seed"]), spec, dev)
    optimizer = Adam(1e-3)
    step = make_dp_reinforce_step(cfg, spec, optimizer, args["games_per_device"], mesh)
    gen = mesh.generator(args["seed"] + 1)
    p, o, m = step(params, optimizer.init(params), gen)
    synchronize(dev)
    start = time.perf_counter()
    for _ in range(args["steps"]):
        p, o, m = step(p, o, gen)
    synchronize(dev)
    seconds = (time.perf_counter() - start) / args["steps"]
    digest = hashlib.sha256()
    for leaf in tree_leaves(p):
        digest.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return {"rank": rank, "device": str(dev), "seconds_per_update": seconds, "params_digest": digest.hexdigest(),
            "metrics": {k: float(v) for k, v in m.items()},
            "launches": {k: v for k, v in _build.LAUNCHES.items() if v}}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--games-per-device", type=int, default=256)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default="nccl")
    parser.add_argument("--max-devices", type=int, default=1, help="the devices a gloo sweep may use")
    args = parser.parse_args(argv)

    from ..ops import _build
    from ..parallel.launch import spawn
    from ..utils.device import resolve_device

    if args.backend == "nccl":
        resolve_device("cuda")          # NCCL reduces on the cards: without one this raises
    n_total = torch.cuda.device_count() if args.backend == "nccl" else args.max_devices
    dev = resolve_device(args.device)
    if args.backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL reduces CUDA tensors: pass --device cuda, or --backend gloo")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        _build.build()       # once here, not in every rank of the first world
    print(f"{args.backend} ranks on {torch.cuda.get_device_name(0) if cards else 'the CPU'}; "
          f"{n_total} devices available")
    rank_args = {"games_per_device": args.games_per_device, "steps": args.steps, "seed": args.seed,
                 "device": args.device}
    rows, worlds = [], []
    for n in device_counts(n_total):
        results = spawn(worker, n, rank_args, backend=args.backend)
        if len({r["params_digest"] for r in results}) != 1:
            raise RuntimeError(f"the {n} ranks ended with different params")
        dt = results[0]["seconds_per_update"]
        rows.append({"devices": n, "ms_per_update": dt * 1e3, "games_per_s": n * args.games_per_device / dt})
        worlds.append({"devices": n, "shared": args.backend == "gloo" or n > cards, "ranks": results})

    base = rows[0]["games_per_s"]
    for r, w in zip(rows, worlds):
        r["efficiency"] = r["games_per_s"] / (r["devices"] * base)
        print(
            f"devices {r['devices']:>3}  {r['ms_per_update']:8.2f} ms/update  "
            f"{r['games_per_s']:>12,.0f} games/s  eff {r['efficiency']:.2f}"
            + ("  [ranks share cores or a card: code-path check only]" if w["shared"] else "")
        )
    out = {"virtual_mesh": any(w["shared"] for w in worlds), "rows": rows}
    print(json.dumps(out))
    return {**out, "worlds": worlds}


if __name__ == "__main__":
    main()
