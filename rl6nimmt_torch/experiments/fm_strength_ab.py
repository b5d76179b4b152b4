"""Learning A/B of the flagship cycle's rollout and replay layouts.

    python -m rl6nimmt_torch.experiments.fm_strength_ab [--seeds 6] [--cycles 150] [--games 1024]
        [--arms engine kernel kernel_fm] [--eval-games 8192] [--eval-keys 3] [--out PATH] [--device cuda]

Port of ``experiments/fm_strength_ab.py``.  The K4 cycles differ from the
engine cycle in their deals' source (K4's Philox deals against K2's: the
same deals for one seed, PARITY_TORCH.md section 2) and the feature-major
cycle in its replay slot order, (t, p, g) against (t, g, p), so PER draws
other transitions (section 18).  This script checks that the learning is the
same: it trains the flagship Noisy-D3QN-PER-10step from the same initial
params under each arm for the same number of cycles (``--games`` games and 8
updates a cycle, Adam 1e-3, PER 200,000, epsilon 0.1), then scores the final
params in the arena (``runtime/arena.py``: greedy noisy act in seat 0 against
three uniform-random seats), ``--eval-keys`` matches of ``--eval-games``.
Arms:

* ``engine``: the engine rollout, row-major replay;
* ``kernel``: K4, row-major replay;
* ``kernel_fm``: K4's feature-major emit, feature-major replay.

Prints a line per seed and arm and a summary (mean, 95% interval, each K4
arm's score minus the engine arm's), and writes the JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch

from .fm_cycle_bench import CAPACITY, FLAGSHIP, LEARN_ITERS

ARMS = ("engine", "kernel", "kernel_fm")


def _setup():
    from ..agents.dqn import DQNConfig, q_network_spec
    from ..engine import EnvConfig

    cfg = EnvConfig(num_players=4)
    dqn = DQNConfig(**FLAGSHIP)
    return cfg, dqn, q_network_spec(dqn, cfg.state_length, cfg.num_actions)


def train(arm: str, seed: int, cycles: int, games: int, dev):
    """The final params of ``cycles`` cycles of ``arm`` from the params of ``seed``."""
    from ..agents.dqn import Adam, tree_map
    from ..buffers import per_init, per_init_fm
    from ..nets import mlp_init
    from ..runtime.vector import dqn_replay_example, make_dqn_selfplay_step

    if arm not in ARMS:
        raise ValueError(f"unknown arm {arm!r}; choose from {ARMS}")
    cfg, dqn, spec = _setup()
    params = mlp_init(torch.Generator(device=dev).manual_seed(seed), spec, dev)
    adam = Adam(1e-3)
    fm = arm == "kernel_fm"
    buf = (per_init_fm if fm else per_init)(CAPACITY, dqn_replay_example(cfg), device=dev)
    cycle = make_dqn_selfplay_step(cfg, dqn, adam, games, learn_iters=LEARN_ITERS, kernel_act_rollout=arm != "engine",
                                   feature_major=fm, device=dev)
    state = (params, tree_map(torch.clone, params), adam.init(params), buf)
    gen = torch.Generator(device=dev).manual_seed(10_000 + seed)
    losses = []
    for c in range(cycles):
        *state, m = cycle(*state, gen, 0.1, c * LEARN_ITERS)
        losses.append(m["loss"])
    losses = torch.stack(losses).cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{arm}, seed {seed}: non-finite loss")
    return state[0]


def evaluate(params, eval_games: int, eval_keys: int, dev):
    """Seat 0's mean score and win rate (greedy noisy DQN against three random seats)."""
    from ..runtime.arena import SeatPolicy, make_arena

    cfg, dqn, spec = _setup()
    policies = (SeatPolicy("dqn", spec=spec, dqn_cfg=dqn),) + (SeatPolicy("random"),) * 3
    arena = make_arena(cfg, policies, eval_games, device=dev)
    scores, wins = [], []
    for e in range(eval_keys):
        s = arena((params, None, None, None), (0.0,) * 4, torch.Generator(device=dev).manual_seed(777 + e))
        s = s.cpu().numpy()
        scores.append(s[:, 0].mean())
        wins.append((np.argmax(s, axis=1) == 0).mean())
    return float(np.mean(scores)), float(np.mean(wins))


T_95 = {1: 12.71, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447, 7: 2.365}


def ci95(xs):
    """Mean and the half-width of its 95% t interval (nan for one value)."""
    xs = np.asarray(xs, float)
    if len(xs) < 2:
        return float(xs.mean()), float("nan")
    return float(xs.mean()), float(T_95.get(len(xs) - 1, 2.0) * xs.std(ddof=1) / math.sqrt(len(xs)))


def main(argv=None):
    from ..utils.device import resolve_device
    from .kernel_times import smi_line

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=6)
    parser.add_argument("--arms", nargs="+", default=list(ARMS), choices=ARMS)
    parser.add_argument("--cycles", type=int, default=150)
    parser.add_argument("--games", type=int, default=1024, help="games a cycle")
    parser.add_argument("--eval-games", type=int, default=8192)
    parser.add_argument("--eval-keys", type=int, default=3)
    parser.add_argument("--out", default="rl6nimmt_torch/experiments/results/fm_strength_ab.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    results = {a: {"score": [], "win": []} for a in args.arms}
    for seed in range(args.seeds):
        for arm in args.arms:
            sc, wn = evaluate(train(arm, seed, args.cycles, args.games, dev), args.eval_games, args.eval_keys, dev)
            results[arm]["score"].append(sc)
            results[arm]["win"].append(wn)
            print(f"seed {seed} {arm}: score {sc:.3f} win {wn:.3f}", flush=True)

    out = {"config": {"seeds": args.seeds, "cycles": args.cycles, "games_per_cycle": args.games,
                      "updates_per_cycle": LEARN_ITERS, "eval_games": args.eval_games, "eval_keys": args.eval_keys,
                      "device": str(dev), "card": smi_line() if dev.type == "cuda" else "cpu"}}
    for a in args.arms:
        sm, sc = ci95(results[a]["score"])
        wm, wc = ci95(results[a]["win"])
        out[a] = {"score_mean": sm, "score_ci95": sc, "win_mean": wm, "win_ci95": wc,
                  "per_seed_score": results[a]["score"], "per_seed_win": results[a]["win"]}
    if "engine" in args.arms:
        for other in [a for a in args.arms if a != "engine"]:
            dm, dc = ci95([a - b for a, b in zip(results[other]["score"], results["engine"]["score"])])
            out[f"{other}_minus_engine_score"] = {"mean": dm, "ci95": dc,
                                                   "equivalent": bool(abs(dm) <= dc or abs(dm) < 0.25)}
    print(json.dumps({k: v for k, v in out.items()}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
