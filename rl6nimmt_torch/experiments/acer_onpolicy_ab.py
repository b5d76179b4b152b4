"""ACER's on-policy ratio A/B: all fresh sequences against a subsample.

    python -m rl6nimmt_torch.experiments.acer_onpolicy_ab [--games 4096] [--steps 200] [--on-policy 512]
        [--eval-games 4096] [--seed 0] [--out PATH] [--device cuda]

Port of ``experiments/acer_onpolicy_ab.py``.  The vectorized ACER cycle
(``runtime/vector.py`` ``make_acer_selfplay_step``: a rollout of ``--games``
games, the store of every seat's sequence, one on-policy and one off-policy
update on a minibatch of 512, Adam 1e-3, a 65,536-sequence buffer) runs its
on-policy update on all G*P fresh sequences (``all_fresh``,
``on_policy_sequences=None``) or on a uniform subsample of ``--on-policy`` of
them (``subsampled``).  Both arms train the (100, 100) actor-critic net from
the same seed for ``--steps`` cycles; each is then scored against three
uniform-random seats (the arena's ``policy`` rule, ``runtime/arena.py``), and
the two play each other with the seats alternated (ties half).  If the
per-cycle strength is the same, the subsample is the better configuration:
the same strength a cycle at a fraction of the on-policy work.

Each arm runs one untimed cycle on throwaway state before its timed loop,
so that no arm pays the process's warm-up (JAX's timed loop paid each arm's
compile instead); its training time ends in ``torch.cuda.synchronize()``, and
on the card its peak device memory (``torch.cuda.max_memory_allocated``,
reset after the warm-up) is recorded beside it.  The optimizer is the port's functional ``Adam``
in place of ``optax.adam``, the randomness a ``torch.Generator`` seeded as
JAX's key (``PARITY_TORCH.md`` section 19).  Writes the JSON to ``--out``
and returns it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from . import arena_eval


def train(cfg, spec, games: int, steps: int, seed: int, on_policy, dev):
    """``(params, seconds, final mean score, peak device bytes or None)`` of one arm."""
    from ..agents.dqn import Adam
    from ..buffers import seq_init
    from ..nets import mlp_init
    from ..runtime.vector import acer_sequence_example, make_acer_selfplay_step
    from ..utils.device import synchronize

    optimizer = Adam(1e-3)

    def fresh():
        params = mlp_init(torch.Generator().manual_seed(seed), spec, dev)
        return params, optimizer.init(params), seq_init(1 << 16, cfg.max_turns, acer_sequence_example(cfg), device=dev)

    cycle = make_acer_selfplay_step(cfg, spec, optimizer, games, minibatch=512, on_policy_sequences=on_policy,
                                    device=dev)
    # One untimed cycle on throwaway state, so that each arm's timed loop starts warm: else the arm that runs
    # first would also pay the process's first cuBLAS handle, launcher loads and allocations.
    cycle(*fresh(), torch.Generator(device=dev).manual_seed(seed + 2))
    params, opt_state, buf = fresh()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    synchronize(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt_state, buf, metrics = cycle(params, opt_state, buf, gen)
    score = float(metrics["mean_score"])
    synchronize(dev)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return params, secs, score, peak


def arena_vs_random(cfg, spec, params, games: int, seed: int, dev, noise=None) -> float:
    from ..runtime.arena import SeatPolicy

    return arena_eval.vs_random(SeatPolicy("policy", spec=spec), params, games, seed, dev, noise)


def head_to_head(spec, params_a, params_b, games: int, seed: int, dev, noises=(None, None)):
    from ..runtime.arena import SeatPolicy

    pol = SeatPolicy("policy", spec=spec)
    return arena_eval.head_to_head(pol, pol, params_a, params_b, games, seed, dev, noises)


def main(argv=None):
    from ..engine import EnvConfig
    from ..nets import MLPSpec
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--games", type=int, default=4096)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--on-policy", type=int, default=512)
    parser.add_argument("--eval-games", type=int, default=4096)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="rl6nimmt_torch/experiments/results/acer_onpolicy_ab.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.steps <= 0:
        parser.error("--steps must be positive")
    dev = resolve_device(args.device)

    cfg = EnvConfig(num_players=4)
    spec = MLPSpec(input_size=1 + cfg.state_length, hidden_sizes=(100, 100), head_sizes=(1, 1))

    out = {"games": args.games, "steps": args.steps, "on_policy": args.on_policy}
    arms = {}
    for label, op in (("all_fresh", None), ("subsampled", args.on_policy)):
        params, secs, score, peak = train(cfg, spec, args.games, args.steps, args.seed, op, dev)
        win = arena_vs_random(cfg, spec, params, args.eval_games, args.seed + 7, dev)
        arms[label] = {"params": params, "train_s": round(secs, 4), "final_mean_score": round(score, 3),
                       "win_vs_3_random": round(win, 4), "peak_device_memory_bytes": peak}
        print(f"[{label}] train {secs:.3f}s  final score {score:.3f}  win vs 3 random {win:.4f}"
              + (f"  peak device memory {peak / 2**30:.2f} GiB" if peak is not None else ""), flush=True)

    rate, se, n = head_to_head(spec, arms["all_fresh"]["params"], arms["subsampled"]["params"], args.eval_games,
                               args.seed + 17, dev)
    print(f"[head-to-head] all_fresh vs subsampled: {rate:.4f} ± {se:.4f} over {n} games", flush=True)
    out.update({k: {kk: vv for kk, vv in v.items() if kk != "params"} for k, v in arms.items()})
    out["all_fresh_win_vs_subsampled"] = {"rate": round(rate, 4), "se": round(se, 4), "games": n}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
