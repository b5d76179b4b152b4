"""Profile the device-block tournament path: where does a block's time go?

    python -m rl6nimmt_torch.experiments.profile_devblock [--games 100] [--mc-max 200] [--blocks 2]
        [--bucket N] [--device cuda]

Port of ``experiments/profile_devblock.py``.  Reproduces
``Tournament.play_device_block``'s grouping (the same lineup sampler,
``lineup_signature`` and ``lineup_fastclass`` keys and population-wide
learner slots) for blocks of ``--games`` games of the notebook population
(Random, D3QN, ACER, MCS and Alpha0.5 at ``--mc-max``, ``np.random.seed(0)``,
all in ``train()`` mode), plays each group as one ``DeviceBlockSession`` and
prints the split its ``timings`` record:

* ``assemble_s`` -- host: each seat's params and the block's inputs;
* ``device_s``  -- the block on the card, until its trajectory is on the host;
* ``replay_s``  -- host: every learner's ``learn`` stream replayed.

The first block is labelled cold, the others warm.  Eager PyTorch compiles
nothing, so cold and warm differ only by the caches of the first calls
(``PARITY_TORCH.md`` sections 14 and 19).  Each group ends with
``torch.cuda.synchronize()`` before the block's total is read.  Returns the
printed figures.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    from ..runtime.device_tournament import (DeviceBlockSession, LearnerSlot, lineup_fastclass, lineup_signature,
                                             seat_slot)
    from ..tournament import Tournament
    from ..utils.device import resolve_device, synchronize
    from .simple_tournament import population

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--games", type=int, default=100)
    parser.add_argument("--mc-max", type=int, default=200)
    parser.add_argument("--blocks", type=int, default=2)
    parser.add_argument("--bucket", type=int, default=None,
                        help="accepted for the JAX script's command line and has no effect: the JAX block "
                             "padded its games to one compiled width, and eager PyTorch compiles nothing "
                             "(it must still cover --games)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    bucket = args.bucket or max(8, 1 << (args.games - 1).bit_length())

    np.random.seed(0)
    agents = population(0, args.mc_max, device=dev)
    for a in agents.values():
        a.train()
    tournament = Tournament(min_players=2, max_players=4, device=dev)
    for name, agent in agents.items():
        tournament.add_player(name, agent)

    slots = set()
    for name in tournament.agents:
        role = seat_slot(tournament.agents[name])
        if role is not None and role[0] == "learner":
            slots.add(role[1])
    slots = tuple(sorted(slots, key=LearnerSlot.sort_key))

    out = {}
    for b in range(args.blocks):
        picks = [tournament._choose_players(None) for _ in range(args.games)]
        groups = {}
        for j, (names, ags) in enumerate(picks):
            sig = lineup_signature(ags)
            key = sig[:2] + (lineup_fastclass(ags),)
            groups.setdefault(key, []).append((j, ags))
        label = "cold" if b == 0 else "warm"
        rows = []
        t0 = time.perf_counter()
        for (cfg, _, fast), group in groups.items():
            sess = DeviceBlockSession([ags for _, ags in group], bucket=bucket, slots=slots, device=dev)
            sess.play()
            synchronize(dev)
            t = sess.timings
            rows.append({"P": cfg.num_players, "fast": list(fast), "games": len(group), **t})
            print(f"[{label}] P={cfg.num_players} fast={fast} games={len(group)} "
                  f"assemble={t['assemble_s']:.2f}s device={t['device_s']:.2f}s "
                  f"replay={t['replay_s']:.2f}s", flush=True)
        total = time.perf_counter() - t0
        print(f"[{label}] block total: {total:.2f}s", flush=True)
        out[f"block{b}"] = {"label": label, "groups": rows, "total_s": total}
    return out


if __name__ == "__main__":
    main()
