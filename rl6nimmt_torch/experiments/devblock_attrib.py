"""Attribute a device block's time to its seat kinds.

    python -m rl6nimmt_torch.experiments.devblock_attrib [--games 32] [--players 4] [--mc-max 200]
        [--batch 8] [--reps 3] [--device cuda]

Port of ``experiments/devblock_attrib.py``.  Builds one block program
(``runtime/device_tournament.py`` ``make_device_block_fn``: G games of P
seats, ``--mc-max`` playouts, ``--batch`` playouts a round) and times it with
every seat forced to one kind, the same fresh (100, 100) prior in every seat
and the same noise (a generator seeded 42) in every run:

* ``random``       -- the block's skeleton: 10 turns, the decision's bookkeeping, no playouts;
* ``mcs``          -- + playout rounds with uniform moves;
* ``puct_uniform`` -- + the PUCT root over the net's prior (uniform playouts);
* ``puct``         -- + net playouts (the policy forward in every playout turn);
* ``mcs/puct_free`` and ``mcs/pf+uni`` -- MCS seats as a PUCT-free lineup runs
  them: one round of ``min(mc_ceiling, SINGLE_ROUND_CAP)`` lanes a seat (the
  budget's pow2 ceiling, 256 at most);
* ``puct/K32``     -- PUCT at 32 playouts a round.

JAX compiled ``puct_free`` and ``uniform_playouts`` as static program
variants; the port's search call skips that work from its seats' kinds
(``PARITY_TORCH.md`` sections 14 and 19), so the two PUCT-free arms are the
same program here and both are printed.  One untimed run precedes the
``--reps`` timed ones; each ends in ``torch.cuda.synchronize()``.  Prints the
fastest run's ms and ms a game for each arm, and returns them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def arms(cfg, spec, G: int, mc_max: int, batch: int, dev):
    """``[(name, kind, block fn)]`` of the script's arms."""
    from ..agents.device_search import KIND_PUCT, KIND_PUCT_UNIFORM, KIND_RANDOM, KIND_UNIFORM
    from ..runtime.device_tournament import SINGLE_ROUND_CAP, make_device_block_fn

    fn = make_device_block_fn(cfg, spec, G, mc_max, batch, (), device=dev)
    mc_ceiling = 1 << (mc_max - 1).bit_length()
    fn_free = make_device_block_fn(cfg, spec, G, mc_ceiling, min(mc_ceiling, SINGLE_ROUND_CAP), (), device=dev)
    fn32 = make_device_block_fn(cfg, spec, G, mc_ceiling, 32, (), device=dev)
    return [
        ("random", KIND_RANDOM, fn),
        ("mcs", KIND_UNIFORM, fn),
        ("puct_uniform", KIND_PUCT_UNIFORM, fn),
        ("puct", KIND_PUCT, fn),
        ("mcs/puct_free", KIND_UNIFORM, fn_free),
        ("mcs/pf+uni", KIND_UNIFORM, fn_free),
        ("puct/K32", KIND_PUCT, fn32),
    ]


def main(argv=None):
    from ..engine import EnvConfig
    from ..nets import MLPSpec, mlp_init
    from ..utils.device import resolve_device, synchronize

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--games", type=int, default=32)
    parser.add_argument("--players", type=int, default=4)
    parser.add_argument("--mc-max", type=int, default=200)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    G, P = args.games, args.players
    cfg = EnvConfig(num_players=P)
    spec = MLPSpec(input_size=48, hidden_sizes=(100, 100), head_sizes=(1,))
    p1 = mlp_init(torch.Generator().manual_seed(0), spec, dev)
    params = [[p1] * P for _ in range(G)]
    mc_maxes = np.full((G, P), args.mc_max, np.int32)
    mc_pers = np.full((G, P), 10, np.int32)
    c_pucts = np.full((G, P), 2.0, np.float32)
    epses = np.zeros((G, P), np.float32)

    out = {}
    for name, kind, fn in arms(cfg, spec, G, args.mc_max, args.batch, dev):
        kinds = np.full((G, P), kind, np.int32)

        def run():
            fn(params, (), kinds, mc_maxes, mc_pers, c_pucts, epses, torch.Generator(device=dev).manual_seed(42))
            synchronize(dev)

        run()   # untimed: the first calls' caches
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            run()
            ts.append(time.perf_counter() - t0)
        out[name] = {"min_ms": min(ts) * 1e3, "per_game_ms": min(ts) / G * 1e3}
        print(f"{name:13s} min={min(ts)*1e3:8.1f} ms  per-game={min(ts)/G*1e3:6.2f} ms", flush=True)
    return out


if __name__ == "__main__":
    main()
