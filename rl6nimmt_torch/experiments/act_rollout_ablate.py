"""Ablate the act-rollout kernel (K4) to attribute its milliseconds.

    python -m rl6nimmt_torch.experiments.act_rollout_ablate [env obs mm full]

Variants (cumulative, ``ops/act_ablate_kernel.py``; K6 on the card):

* ``env``  -- deal and uniform-legal play, per-turn actions and rewards (K3's games);
* ``obs``  -- plus K4's int8 observation writes;
* ``mm``   -- plus K4's hidden layer and the full 104-wide advantage head per
  seat, folded into the pick so that it stays live;
* ``full`` -- plus the greedy hand-only argmax: K4's own launch.

The defaults are the JAX script's: G=4096 games, a chain of 256 generations,
hidden width 64, ``EnvConfig(4)``, and weights drawn as
``np.random.default_rng(0).normal`` in the order w1, b1, wa, ba.  Generation
``i`` of a chain plays seed ``seed + i``.  Prints ``ms/generation`` per
variant, timed with CUDA events.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..engine.state import EnvConfig
from ..ops.act_ablate_kernel import VARIANTS, make_act_ablate_kernel
from ..utils.device import resolve_device

G, CHAIN = 4096, 256
HID = 64
SEED = 7


def config() -> EnvConfig:
    return EnvConfig(num_players=4)


def weights(cfg: EnvConfig, device="cuda", hidden: int = HID):
    """``(w1 [T,S,Hd], b1 [T,Hd], wa [T,Hd,A], ba [T,A])`` f32, the JAX script's draws."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    T, S, A = cfg.max_turns, cfg.state_length, cfg.num_actions
    shapes = [(T, S, hidden), (T, hidden), (T, hidden, A), (T, A)]
    return tuple(torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=dev) for s in shapes)


def build(variant: str, device="cuda", games: int = G, chain: int = CHAIN):
    """``many(seed) -> int64[]``: ``chain`` generations of ``variant``, each
    adding ``sum(rewards) + sum(actions) + sum(obs[0])`` to the checksum
    (``env`` writes no observations, so its ``obs[0]`` term is left out)."""
    dev = resolve_device(device)
    cfg = config()
    w = weights(cfg, dev)
    play = make_act_ablate_kernel(cfg, games, HID, variant)

    def many(seed: int):
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(chain):
            obs, actions, rewards = play(seed + i, *w)
            acc += rewards.sum(dtype=torch.int64) + actions.sum(dtype=torch.int64)
            if obs is not None:
                acc += obs[0].sum(dtype=torch.int64)
        return acc

    return many


def timeit(fn, iters: int = 5, chain: int = CHAIN, seed: int = SEED) -> float:
    """Median milliseconds per generation of ``fn(seed)`` over ``iters`` calls
    of ``chain`` generations each (CUDA events, after one warm-up call)."""
    fn(seed)
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(seed)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2] / chain


def main(argv=None) -> int:
    variants = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    for v in variants:
        ms = timeit(build(v))
        print(f"{v:5s}: {ms:7.3f} ms/generation", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
