"""Per-decision search latency on the card: host-root path vs whole device decisions.

    python -m rl6nimmt_torch.experiments.search_latency [--mc-max 400] [--reps 10] [--block 8]

Port of ``experiments/search_latency.py``.  Measures seconds per decision on
a fixed opening position (full 10-card hand, 4 players, dealt by K2 from seed
123) for MCS and PUCT ("Alpha0.5"), comparing

* the host-root path (root logic on the host, one playout call per round --
  ``device_root=False``), and
* the device-root path (the whole decision in ``agents/device_search.py`` --
  ``device_root=True``),

each alone and over a block of G simultaneous games (``forward_many``, the
block driver's shape).  Host clock around calls whose results reach the host.
Prints one line per row and one JSON line with the card's name and power
limit.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..agents.mcs import MCSAgent, PUCTAgent
from ..engine import EnvConfig, deal, observe
from ..utils.device import resolve_device
from .kernel_times import smi_line


def opening(device):
    """Seat 0's observation and legal cards in the opening position of seed 123."""
    cfg = EnvConfig(4)
    state = deal(cfg, 123, 1, device=device)
    obs, _ = observe(cfg, state)
    return obs[0, 0].cpu().numpy().astype(np.float32), [c for c in state.hands_sorted[0, 0].tolist() if c >= 0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mc-max", type=int, default=400)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--block", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    state0, legal0 = opening(dev)

    def measure(agent, reps):
        # A full-hand forward re-initializes the card memory each call, so
        # every rep is the same root decision.
        agent.forward(state0, legal0)
        t0 = time.perf_counter()
        for _ in range(reps):
            agent.forward(state0, legal0)
        return (time.perf_counter() - t0) / reps

    def measure_block(agent, reps, G):
        memories = [agent.new_memory() for _ in range(G)]
        call = lambda: agent.forward_many([state0] * G, [legal0] * G, memories)
        call()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        return (time.perf_counter() - t0) / reps

    rows = []
    for name, cls in (("MCS", MCSAgent), ("Alpha0.5", PUCTAgent)):
        for device_root in (False, True):
            agent = cls(mc_max=args.mc_max, device_root=device_root, seed=0, device=dev)
            dt1 = measure(agent, args.reps)
            dtG = measure_block(agent, max(args.reps // 2, 2), args.block)
            rows.append({"agent": name, "mc_max": args.mc_max, "device_root": device_root,
                         "s_per_decision": dt1, "s_per_decision_block": dtG / args.block, "block": args.block})
            print(f"{name:<9} mc_max={args.mc_max} device_root={str(device_root):<5} {dt1 * 1e3:8.1f} ms/decision "
                  f"  {dtG / args.block * 1e3:8.1f} ms/decision in {args.block}-game blocks", flush=True)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"device": where, "card": smi_line() if dev.type == "cuda" else None, "rows": rows}))


if __name__ == "__main__":
    main()
