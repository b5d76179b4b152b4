"""Steady-state speed of device-side learner updates against the host learn replay.

    python -m rl6nimmt_torch.experiments.device_learn_speedup [--games 1000] [--block 100] [--seed 0]
        [--pairs 0] [--out PATH] [--device cuda]

Port of ``experiments/device_learn_speedup.py``.  Runs the same learner-heavy
tournament twice -- the host learn replay, then ``device_learning=True``
(``runtime/device_learn.py``) -- and reports the wall time a game and the
``assemble_s``/``device_s``/``replay_s`` split that
``DeviceBlockSession.finalize`` stamps into the session's ``timings``
(summed over the timed blocks).  Population: ``DQNVanilla`` (minibatch 64),
the flagship Noisy-D3QN-PER-10step (minibatch 64, 100,000 buffer), ACER
(warmup 100, minibatch 5), action-in-input REINFORCE and a ``DrunkHamster``,
2-4 seats a game drawn as the reference protocol: at least 3 of every 4 seats
train every game.  The first block of each arm is a warm-up and is not timed.

``--pairs N`` runs N interleaved pairs (both arms back to back, the order
alternating) and reports each arm's mean ms a game with a 95% t interval,
the per-pair host/device ratios with theirs, and a verdict: whether the ratio's
interval excludes 1.0.

Each timed segment starts and ends with ``torch.cuda.synchronize()``.
``replay_s`` is host time: with device learning the replay's last kernels may
still be running when it is stamped (``PARITY_TORCH.md`` section 15), and
the segment's wall time includes them.  Writes the JSON to ``--out`` and
returns it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

# Two-sided 95% t critical values, keyed by degrees of freedom (n - 1).
T_95 = {1: 12.71, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228}


def ci95(xs):
    """Mean and the half-width of its 95% t interval (nan for one value)."""
    xs = np.asarray(xs, np.float64)
    m = float(xs.mean())
    if len(xs) < 2:
        return m, float("nan")
    t = T_95.get(len(xs) - 1, 2.0 if len(xs) > 11 else 12.71)
    return m, float(t * xs.std(ddof=1) / np.sqrt(len(xs)))


def verdict(ratio_m: float, ratio_ci: float) -> str:
    if ratio_m - ratio_ci > 1.0:
        return "device faster (CI excludes 1.0)"
    if ratio_m + ratio_ci < 1.0:
        return "host faster (CI excludes 1.0)"
    return "statistical tie (CI includes 1.0)"


def build_tournament(dev):
    from ..agents import BatchedACERAgent, BatchedReinforceAgent, DrunkHamster
    from ..agents.dqn import DQNVanilla, Noisy_D3QN_PRB_NStep
    from ..tournament import Tournament

    t = Tournament(min_players=2, max_players=4, device=dev)
    agents = {
        "dqn": DQNVanilla(seed=11, minibatch=64, device=dev),
        "d3qn": Noisy_D3QN_PRB_NStep(seed=12, minibatch=64, n_steps=10, history_length=100_000, device=dev),
        "acer": BatchedACERAgent(seed=13, warmup=100, minibatch=5, device=dev),
        "reinforce": BatchedReinforceAgent(seed=14, device=dev),
        "random": DrunkHamster(seed=15, device=dev),
    }
    for name, agent in agents.items():
        if name != "random":
            agent.train()
        t.add_player(name, agent)
    return t


def run(device_learning: bool, games: int, block: int, seed: int, dev):
    """One arm: a warm-up block, then ``games - block`` timed games."""
    from ..runtime import device_tournament as DT
    from ..utils.device import synchronize

    np.random.seed(seed)
    t = build_tournament(dev)
    splits = {"assemble_s": 0.0, "device_s": 0.0, "replay_s": 0.0}
    # The tournament dispatches and finalizes each group itself; finalize
    # stamps the timings, so the split is summed there.
    orig_finalize = DT.DeviceBlockSession.finalize

    def finalize(self):
        out = orig_finalize(self)
        for k in splits:
            splits[k] += self.timings.get(k, 0.0)
        return out

    DT.DeviceBlockSession.finalize = finalize
    try:
        t.play_device_block(block, device_learning=device_learning)
        for k in splits:
            splits[k] = 0.0
        synchronize(dev)
        start = time.perf_counter()
        played = block
        while played < games:
            t.play_device_block(block, device_learning=device_learning)
            played += block
        synchronize(dev)
        wall = time.perf_counter() - start
    finally:
        DT.DeviceBlockSession.finalize = orig_finalize
    return {
        "device_learning": device_learning,
        "games": played - block,
        "wall_s": round(wall, 2),
        "ms_per_game": round(wall / (played - block) * 1e3, 2),
        "splits_s": {k: round(v, 2) for k, v in splits.items()},
    }


def main(argv=None):
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--games", type=int, default=1000)
    parser.add_argument("--block", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pairs", type=int, default=0,
                        help=">0: interleaved A/B pairs with mean +/- CI; each pair runs both arms, "
                             "order alternating, --games games per segment")
    parser.add_argument("--out", default="rl6nimmt_torch/experiments/results/device_learn_speedup.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.games <= args.block:
        parser.error("--games must exceed --block (the first block is an untimed warm-up)")
    dev = resolve_device(args.device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)

    if not args.pairs:
        results = {}
        for dl in (False, True):
            label = "device" if dl else "host"
            print(f"=== {label} learning: {args.games} games ===", flush=True)
            results[label] = run(dl, args.games, args.block, args.seed, dev)
            print(json.dumps(results[label]), flush=True)
        results["speedup"] = round(results["host"]["wall_s"] / results["device"]["wall_s"], 3)
        print(json.dumps({"speedup_host_over_device": results["speedup"]}))
        Path(args.out).write_text(json.dumps(results, indent=1))
        return results

    # Each pair runs both arms back to back, the order alternating, so drift
    # cancels in the pairwise ratios; the verdict asks whether the ratios'
    # interval excludes 1.0.
    segments = {"host": [], "device": []}
    details = {"host": [], "device": []}
    for pair in range(args.pairs):
        order = (False, True) if pair % 2 == 0 else (True, False)
        for dl in order:
            label = "device" if dl else "host"
            r = run(dl, args.games, args.block, args.seed + pair, dev)
            segments[label].append(r["ms_per_game"])
            details[label].append(r)
            print(f"pair {pair} {label}: {r['ms_per_game']} ms/game (splits {r['splits_s']})", flush=True)

    host_m, host_ci = ci95(segments["host"])
    dev_m, dev_ci = ci95(segments["device"])
    ratios = [h / d for h, d in zip(segments["host"], segments["device"])]
    ratio_m, ratio_ci = ci95(ratios)
    results = {
        "pairs": args.pairs,
        "games_per_segment": args.games,
        "block": args.block,
        "host_ms_per_game": {"mean": round(host_m, 2), "ci95": round(host_ci, 2), "all": segments["host"]},
        "device_ms_per_game": {"mean": round(dev_m, 2), "ci95": round(dev_ci, 2), "all": segments["device"]},
        "speedup_host_over_device": {"mean": round(ratio_m, 3), "ci95": round(ratio_ci, 3),
                                     "all": [round(r, 3) for r in ratios]},
        "verdict": verdict(ratio_m, ratio_ci),
        "detail": details,
    }
    print(json.dumps({k: v for k, v in results.items() if k != "detail"}, indent=1), flush=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
