"""N-seed learning-curve A/B for the performance-profile options of REINFORCE and ACER.

    python -m rl6nimmt_torch.experiments.profile_ab [--seeds 8] [--games 1024] [--cycles 400]
        [--acer-cycles 120] [--curve-every 25] [--curve-every-acer 10] [--eval-games 4096]
        [--family both|reinforce|acer] [--out PATH] [--device cuda]

Port of ``experiments/profile_ab.py``.  Two options of the vectorized
learners, each against its default, over ``--seeds`` independent seeds:

* REINFORCE ``fused_grad=True`` against ``fused_grad=False`` (the default
  arm), at equal cycles: the two arms play the same trajectories from one
  seed and differ in their loss by round-off;
* ACER ``on_policy_sequences=512`` (``subsampled``) against all fresh
  sequences (``all_fresh``), at equal wall clock: each arm's seconds a cycle
  are measured over 5 warm cycles (after one untimed) and the subsampled
  arm's count of cycles is scaled so that both spend the same time.

Both nets are the (100, 100) action-in-input nets with Adam 1e-3 (the port's
functional ``Adam``).  Each seed's trained arms are scored by their win rate
against three uniform-random seats (seat 0's top score, shared tops count)
and by a head-to-head with the seats alternated (ties half), through
``arena_eval``; the seed-level means, standard errors and Welch's t are
written to ``--out``, which is returned.  A JAX key ``key(n)`` becomes a
``torch.Generator`` seeded ``n`` (``PARITY_TORCH.md`` section 19); the
scorers also take injected ``ArenaNoise``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import arena_eval


def welch_t(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    va, vb = a.var(ddof=1) / len(a), b.var(ddof=1) / len(b)
    if va + vb == 0:
        return 0.0
    return float((a.mean() - b.mean()) / np.sqrt(va + vb))


def arena_vs_random(cfg, spec, params, games: int, seed: int, dev, noise=None) -> float:
    from ..runtime.arena import SeatPolicy

    return arena_eval.vs_random(SeatPolicy("policy", spec=spec), params, games, seed, dev, noise)


def head_to_head(spec, params_a, params_b, games: int, seed: int, dev, noises=(None, None)) -> float:
    """A's rate (ties half) over ``games`` with A in seat 0 (key ``seed``) and
    ``games`` with B there (key ``seed + 1``)."""
    from ..runtime.arena import SeatPolicy

    pol = SeatPolicy("policy", spec=spec)
    return arena_eval.head_to_head(pol, pol, params_a, params_b, games, seed, dev, noises)[0]


def _fresh_net(spec, seed: int, dev):
    from ..nets import mlp_init

    return mlp_init(torch.Generator().manual_seed(seed), spec, dev)


# ------------------------------------------------------------------ REINFORCE


def reinforce_ab(cfg, args, dev):
    from ..agents.dqn import Adam
    from ..nets import MLPSpec
    from ..runtime.vector import make_reinforce_train_step

    spec = MLPSpec(input_size=1 + cfg.state_length, hidden_sizes=(100, 100), head_sizes=(1,))
    optimizer = Adam(1e-3)
    steps = {label: make_reinforce_train_step(cfg, spec, optimizer, args.games, fused_grad=fused, device=dev)
             for label, fused in (("default", False), ("fused", True))}

    curves = {k: [] for k in steps}
    wins = {k: [] for k in steps}
    h2h = []
    for seed in range(args.seeds):
        params_by_arm = {}
        for label, step in steps.items():
            params = _fresh_net(spec, 100 + seed, dev)
            opt_state = optimizer.init(params)
            gen = torch.Generator(device=dev).manual_seed(200 + seed)
            curve = []
            for i in range(args.cycles):
                params, opt_state, m = step(params, opt_state, gen)
                if (i + 1) % args.curve_every == 0:
                    curve.append(round(float(m["mean_score"]), 3))
            curves[label].append(curve)
            wins[label].append(arena_vs_random(cfg, spec, params, args.eval_games, 777 + seed, dev))
            params_by_arm[label] = params
        h2h.append(head_to_head(spec, params_by_arm["fused"], params_by_arm["default"], args.eval_games,
                                900 + seed, dev))
        print(f"[reinforce seed {seed}] default={wins['default'][-1]:.4f} "
              f"fused={wins['fused'][-1]:.4f} h2h(fused)={h2h[-1]:.4f}", flush=True)

    return {
        "spec": "action-in-input REINFORCE (registry 'reinforce')",
        "arms": {"default": "recompute-grad (bit-continuous)",
                 "fused": "fused_grad=True packed-row"},
        "protocol": f"{args.seeds} seeds x {args.cycles} cycles @ G={args.games} (equal cycles; identical rollout "
                    f"trajectories per seed)",
        "win_vs_3_random": {k: v for k, v in wins.items()},
        "seed_mean": {k: round(float(np.mean(v)), 4) for k, v in wins.items()},
        "seed_se": {k: round(float(np.std(v, ddof=1) / np.sqrt(len(v))), 4) for k, v in wins.items()},
        "welch_t_default_minus_fused": round(welch_t(wins["default"], wins["fused"]), 3),
        "head_to_head_fused_rate": [round(x, 4) for x in h2h],
        "head_to_head_fused_mean": round(float(np.mean(h2h)), 4),
        "mean_score_curves": curves,
    }


# ----------------------------------------------------------------------- ACER


def acer_ab(cfg, args, dev):
    from ..agents.dqn import Adam
    from ..buffers import seq_init
    from ..nets import MLPSpec
    from ..runtime.vector import acer_sequence_example, make_acer_selfplay_step
    from ..utils.device import synchronize

    spec = MLPSpec(input_size=1 + cfg.state_length, hidden_sizes=(100, 100), head_sizes=(1, 1))
    optimizer = Adam(1e-3)
    new_buf = lambda: seq_init(1 << 15, cfg.max_turns, acer_sequence_example(cfg), device=dev)
    arms = {"all_fresh": None, "subsampled": 512}
    cycles_of = {}
    steps = {}
    for label, op in arms.items():
        steps[label] = make_acer_selfplay_step(cfg, spec, optimizer, args.games, minibatch=512,
                                               on_policy_sequences=op, device=dev)
        # Equal-wall budgets: time 5 cycles warm, derive each arm's count.
        params = _fresh_net(spec, 0, dev)
        opt_state = optimizer.init(params)
        buf = new_buf()
        gen = torch.Generator(device=dev).manual_seed(1)
        params, opt_state, buf, m = steps[label](params, opt_state, buf, gen)
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            params, opt_state, buf, m = steps[label](params, opt_state, buf, gen)
        synchronize(dev)
        cycles_of[label] = (time.perf_counter() - t0) / 5
    base = args.acer_cycles  # all_fresh cycle count
    counts = {"all_fresh": base,
              "subsampled": int(round(base * cycles_of["all_fresh"] / cycles_of["subsampled"]))}
    print(f"[acer] per-cycle s: { {k: round(v, 3) for k, v in cycles_of.items()} } "
          f"-> equal-wall cycle counts {counts}", flush=True)

    curves = {k: [] for k in arms}
    wins = {k: [] for k in arms}
    h2h = []
    for seed in range(args.seeds):
        params_by_arm = {}
        for label in arms:
            params = _fresh_net(spec, 300 + seed, dev)
            opt_state = optimizer.init(params)
            buf = new_buf()
            gen = torch.Generator(device=dev).manual_seed(400 + seed)
            curve = []
            every = max(1, counts[label] // (args.acer_cycles // args.curve_every_acer))
            for i in range(counts[label]):
                params, opt_state, buf, m = steps[label](params, opt_state, buf, gen)
                if (i + 1) % every == 0:
                    curve.append(round(float(m["mean_score"]), 3))
            curves[label].append(curve)
            wins[label].append(arena_vs_random(cfg, spec, params, args.eval_games, 555 + seed, dev))
            params_by_arm[label] = params
        h2h.append(head_to_head(spec, params_by_arm["subsampled"], params_by_arm["all_fresh"], args.eval_games,
                                600 + seed, dev))
        print(f"[acer seed {seed}] all_fresh={wins['all_fresh'][-1]:.4f} "
              f"subsampled={wins['subsampled'][-1]:.4f} "
              f"h2h(subsampled)={h2h[-1]:.4f}", flush=True)

    return {
        "spec": "ACER (registry 'acer')",
        "arms": {"all_fresh": "on_policy_sequences=None (bit-continuous default)",
                 "subsampled": "on_policy_sequences=512"},
        "protocol": (f"{args.seeds} seeds, EQUAL WALL CLOCK: "
                     f"{counts['all_fresh']} all-fresh cycles vs "
                     f"{counts['subsampled']} subsampled cycles @ G={args.games}"),
        "equal_wall_cycle_counts": counts,
        "per_cycle_seconds": {k: round(v, 4) for k, v in cycles_of.items()},
        "win_vs_3_random": {k: v for k, v in wins.items()},
        "seed_mean": {k: round(float(np.mean(v)), 4) for k, v in wins.items()},
        "seed_se": {k: round(float(np.std(v, ddof=1) / np.sqrt(len(v))), 4) for k, v in wins.items()},
        "welch_t_allfresh_minus_subsampled": round(welch_t(wins["all_fresh"], wins["subsampled"]), 3),
        "head_to_head_subsampled_rate": [round(x, 4) for x in h2h],
        "head_to_head_subsampled_mean": round(float(np.mean(h2h)), 4),
        "mean_score_curves": curves,
    }


def main(argv=None):
    from ..engine import EnvConfig
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--games", type=int, default=1024)
    parser.add_argument("--cycles", type=int, default=400)       # reinforce
    parser.add_argument("--acer-cycles", type=int, default=120)  # all-fresh arm
    parser.add_argument("--curve-every", type=int, default=25)
    parser.add_argument("--curve-every-acer", type=int, default=10)
    parser.add_argument("--eval-games", type=int, default=4096)
    parser.add_argument("--family", choices=("both", "reinforce", "acer"), default="both")
    parser.add_argument("--out", default="rl6nimmt_torch/experiments/results/profile_ab_r4.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = EnvConfig(num_players=4)
    out = {}
    if args.family in ("both", "reinforce"):
        out["reinforce"] = reinforce_ab(cfg, args, dev)
    if args.family in ("both", "acer"):
        out["acer"] = acer_ab(cfg, args, dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
