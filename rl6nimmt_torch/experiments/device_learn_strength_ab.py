"""Per-family strength A/B: device-side learning against the host learn replay.

    python -m rl6nimmt_torch.experiments.device_learn_strength_ab [--seeds 6] [--games 240] [--block 120]
        [--eval-games 4096] [--families per_dqn,acer,reinforce] [--out PATH] [--device cuda]

Port of ``experiments/device_learn_strength_ab.py``.  For each learner family
(``per_dqn``: Noisy-D3QN-PER-10step, minibatch 64, 100,000 buffer; ``acer``:
warmup 100, minibatch 5; ``reinforce``: action-in-input REINFORCE) and each
seed, two arms train the same learner against two ``DrunkHamster`` seats
under the same tournament protocol (``Tournament(2, 4)``, the same
``np.random.seed``, ``play_device_block`` in blocks of ``--block``), one with
the host learn replay and one with ``device_learning=True``
(``runtime/device_learn.py``).  Each arm's final params are then scored in
the arena (``runtime/arena.py``): the win rate against three uniform-random
seats, and the device arm's alternating-seat head-to-head rate against the
host arm (ties count half).  The last field says whether the two arms ended
with bit-equal params.

``PARITY_TORCH.md`` section 15: the port's D3QN and REINFORCE device replays
equal the host replay bit for bit, and its PER planner keeps JAX's float64
bookkeeping, so ``per_dqn`` may read bit-equal here where JAX's float32
priorities did not; ACER's device replay agrees within float32 round-off.
Section 19 records the randomness: each arena match takes a
``torch.Generator`` seeded with JAX's key integer, or an injected
``ArenaNoise``.  Writes the JSON to ``--out`` and returns it.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from . import arena_eval

FAMILIES = ("per_dqn", "acer", "reinforce")


def build_tournament(family: str, seed: int, dev):
    from ..agents import BatchedACERAgent, BatchedReinforceAgent, DrunkHamster
    from ..agents.dqn import Noisy_D3QN_PRB_NStep
    from ..tournament import Tournament

    if family == "per_dqn":
        learner = Noisy_D3QN_PRB_NStep(seed=seed, minibatch=64, n_steps=10, history_length=100_000, device=dev)
    elif family == "acer":
        learner = BatchedACERAgent(seed=seed, warmup=100, minibatch=5, device=dev)
    elif family == "reinforce":
        learner = BatchedReinforceAgent(seed=seed, device=dev)
    else:
        raise ValueError(family)
    learner.train()

    t = Tournament(min_players=2, max_players=4, device=dev)
    t.add_player("learner", learner)
    t.add_player("r1", DrunkHamster(seed=seed + 1000, device=dev))
    t.add_player("r2", DrunkHamster(seed=seed + 2000, device=dev))
    return t, learner


def train_arm(family: str, seed: int, games: int, block: int, device_learning: bool, dev):
    np.random.seed(seed)
    t, learner = build_tournament(family, seed, dev)
    played = 0
    while played < games:
        t.play_device_block(block, device_learning=device_learning)
        played += block
    return learner


def seat_policy(family: str, learner):
    from ..runtime.arena import SeatPolicy

    if family == "per_dqn":
        return SeatPolicy("dqn", spec=learner.spec, dqn_cfg=learner.cfg)
    return SeatPolicy("policy", spec=learner.spec)


def eval_policy(family: str, learner, eval_games: int, seed: int, dev, noise=None) -> float:
    return arena_eval.vs_random(seat_policy(family, learner), learner.params, eval_games, seed, dev, noise)


def head_to_head(family: str, a, b, eval_games: int, seed: int, dev, noises=(None, None)) -> float:
    return arena_eval.head_to_head(seat_policy(family, a), seat_policy(family, b), a.params, b.params, eval_games,
                                   seed, dev, noises)[0]


def params_bit_equal(a, b) -> bool:
    """Every leaf of the two parameter trees equal, bit for bit."""
    from ..utils.ops import leaves_with_paths

    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    return len(la) == len(lb) and all(pa == pb and torch.equal(x.cpu(), y.cpu()) for (pa, x), (pb, y) in zip(la, lb))


def summarize(host_w, dev_w, h2h, params_equal, seeds: int, games: int, block: int, eval_games: int) -> dict:
    """One family's JSON record (JAX's keys and rounding)."""
    host_w, dev_w, h2h = map(np.asarray, (host_w, dev_w, h2h))
    n = seeds
    delta = dev_w - host_w
    return {
        "protocol": (f"{n} seeds x {games} tournament games vs 2 random "
                     f"agents (blocks of {block}), eval "
                     f"{eval_games} arena games"),
        "win_vs_3_random_host": [round(float(x), 4) for x in host_w],
        "win_vs_3_random_device": [round(float(x), 4) for x in dev_w],
        "delta_device_minus_host_mean": round(float(delta.mean()), 4),
        "delta_ci95": round(float(1.96 * delta.std(ddof=1) / np.sqrt(n)), 4) if n > 1 else None,
        "head_to_head_device_rate": [round(float(x), 4) for x in h2h],
        "head_to_head_device_mean": round(float(h2h.mean()), 4),
        "head_to_head_ci95": round(float(1.96 * h2h.std(ddof=1) / np.sqrt(n)), 4) if n > 1 else None,
        "final_params_bit_equal_per_seed": list(params_equal),
    }


def main(argv=None):
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=6)
    parser.add_argument("--games", type=int, default=240)
    parser.add_argument("--block", type=int, default=120)
    parser.add_argument("--eval-games", type=int, default=4096)
    parser.add_argument("--families", default=",".join(FAMILIES))
    parser.add_argument("--out", default="rl6nimmt_torch/experiments/results/device_learn_strength_ab.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    out = {}
    for family in args.families.split(","):
        host_w, dev_w, h2h, params_equal = [], [], [], []
        for seed in range(args.seeds):
            arms = {dl: train_arm(family, 10 * seed + 1, args.games, args.block, dl, dev) for dl in (False, True)}
            host_w.append(eval_policy(family, arms[False], args.eval_games, 70 + seed, dev))
            dev_w.append(eval_policy(family, arms[True], args.eval_games, 70 + seed, dev))
            h2h.append(head_to_head(family, arms[True], arms[False], args.eval_games, 80 + seed, dev))
            equal = params_bit_equal(arms[False].params, arms[True].params)
            params_equal.append(equal)
            print(f"[{family} seed {seed}] host={host_w[-1]:.4f} "
                  f"device={dev_w[-1]:.4f} h2h(device)={h2h[-1]:.4f} "
                  f"params_equal={equal}", flush=True)
        out[family] = summarize(host_w, dev_w, h2h, params_equal, args.seeds, args.games, args.block,
                                args.eval_games)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
