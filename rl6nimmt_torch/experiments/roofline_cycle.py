"""Roofline accounting for the flagship DQN cycle on one H100.

    python -m rl6nimmt_torch.experiments.roofline_cycle [--chain 256] [--reps 3] [--games 4096]
        [--out PATH] [--device cuda]

Port of ``experiments/roofline_cycle.py``.  It splits the feature-major
flagship cycle (K4's feature-major emit into ``per_init_fm(200_000)``,
``make_dqn_selfplay_step(..., kernel_act_rollout=True, feature_major=True)``,
fm_cycle_bench's ``kernel_fm`` arm) into its rollout, harvest+insert and
learn phases by measured ablation:

* the cycle at learn_iters 8 and at 1; one update costs ``(ms8 - ms1) / 7``
  and rollout + harvest + insert ``ms1`` less one update;
* a chain of the raw feature-major kernel alone, a fresh draw of per-turn
  effective weights and a fresh deal seed a generation, read through the
  sum of its rewards; harvest + insert is the rest of the front.

Each measurement is the best of ``--reps`` chains of ``--chain`` cycles (or
generations) between two synchronizes, after one untimed chain, in ms a
cycle.  Each phase is held against its floor on the card: the bytes it must
move (JAX's counts, term for term, :func:`analytic_counts`) over the H100
SXM's 3.35 TB/s of HBM, and its operations over the float32 rate (67
TFLOP/s outside the tensor cores; the flagship net computes in float32); the
bfloat16 tensor-core rate is recorded beside them.  No TPU figure is
carried over.  The binding phase is the one that takes the most time; the
twin names it with its share of the cycle and its distance from its floor.
Writes the JSON to ``--out`` and returns it.  ``--chain``, ``--reps`` and
``--games`` only shorten the run (JAX: no flags).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

# NVIDIA's published H100 SXM figures (dense): HBM3 bandwidth, the float32
# rate outside the tensor cores, the bfloat16 tensor-core rate.
H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_BF16_TC_FLOPS = 989e12

G, CHAIN, ITERS = 4096, 256, 8
CAP, MB = 200_000, 64
REPS = 3


def analytic_counts(T: int, P: int, S: int, G: int, H: int, A: int, N: int, CAP: int, MB: int, ITERS: int) -> dict:
    """The bytes and operations each phase must move or do, as the JAX
    script counts them (``experiments/roofline_cycle.py:143-168``)."""
    int8 = 1
    f32 = 4
    # rollout: read per-turn effective weights, write int8 trajectory + actions/rewards (i32).
    bytes_rollout = (
        T * (S * H + H + H * A + A) * f32          # effective weights read
        + (T + 1) * P * S * G * int8               # obs trajectory write
        + 2 * T * P * G * f32                      # actions+rewards write
    )
    # per tile of 1024 games: shared 37-feature contraction + per-seat hand contraction + adv head, per turn
    flops_rollout = (G // 1024) * T * (
        2 * (S - 10) * H * 1024
        + P * (2 * 10 * H * 1024 + 2 * H * A * 1024)
    )
    # harvest+insert: read trajectory, write state/next_state int8 planes + reward f32 + action/done int8
    # + priorities; the ring wrap moves the window twice.
    row_bytes = 2 * S * int8 + f32 + 2 * int8 + f32  # per transition incl pri
    bytes_insert = (T + 1) * P * S * G * int8 + 3 * N * row_bytes
    # learn: ITERS x (priority reduction over CAP + minibatch forwards/backward)
    bytes_learn = ITERS * (2 * CAP * f32 + MB * (2 * S * int8 + 8 * f32))
    flops_learn = ITERS * (
        # fwd local(s,s') + target(s') + bwd ~2x fwd, batch MB
        5 * MB * 2 * (S * H + H * A)
    )
    return {"bytes_rollout": bytes_rollout, "flops_rollout": flops_rollout, "row_bytes": row_bytes,
            "bytes_insert": bytes_insert, "bytes_learn": bytes_learn, "flops_learn": flops_learn}


def floor_ms(nbytes, nflops, flops_per_s: float = H100_F32_FLOPS) -> float:
    return max(nbytes / H100_HBM_BYTES_PER_S, nflops / flops_per_s) * 1e3


def build(cfg, games: int, learn_iters: int, dev, seed: int = 1):
    """The fm flagship cycle and a fresh ``(params, target, opt_state, buffer)``."""
    from ..agents.dqn import Adam, DQNConfig, q_network_spec, tree_map
    from ..buffers import per_init_fm
    from ..nets import mlp_init
    from ..runtime.vector import dqn_replay_example, make_dqn_selfplay_step
    from .chain_timing import FLAGSHIP

    dqn = DQNConfig(**FLAGSHIP)
    spec = q_network_spec(dqn, cfg.state_length, cfg.num_actions)
    params = mlp_init(torch.Generator().manual_seed(seed), spec, dev)
    adam = Adam(1e-3)
    cycle = make_dqn_selfplay_step(cfg, dqn, adam, games, learn_iters=learn_iters, kernel_act_rollout=True,
                                   feature_major=True, device=dev)
    buf = per_init_fm(CAP, dqn_replay_example(cfg, compact=True), device=dev)
    return cycle, (params, tree_map(torch.clone, params), adam.init(params), buf), dqn, spec


def best_ms(chain_fn, reps: int, chain: int, dev) -> float:
    """Best host ms a cycle of ``reps`` calls of ``chain_fn()`` (``chain``
    cycles each, read on the host) after one untimed call."""
    float(chain_fn())
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        float(chain_fn())
        best = min(best, time.perf_counter() - t0)
    return best / chain * 1e3


def main(argv=None):
    from ..engine import EnvConfig
    from ..nets import draw_mlp_noise, noisy_effective_params
    from ..ops.act_rollout_kernel import make_act_rollout_kernel
    from ..utils.device import resolve_device
    from .kernel_times import smi_line

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chain", type=int, default=CHAIN, help="cycles (generations) a timed chain")
    parser.add_argument("--reps", type=int, default=REPS, help="timed chains; the best counts")
    parser.add_argument("--games", type=int, default=G)
    parser.add_argument("--out", default="rl6nimmt_torch/experiments/results/roofline_cycle.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    games, chain = args.games, args.chain

    cfg = EnvConfig(num_players=4)
    T, P, S = cfg.max_turns, cfg.num_players, cfg.state_length
    H, A = 64, cfg.num_actions
    N = T * P * games  # transitions per cycle

    gen = torch.Generator(device=dev).manual_seed(40)
    ms = {}
    for li in (ITERS, 1):
        cycle, state, dqn, spec = build(cfg, games, li, dev)

        def cycles():
            nonlocal state
            losses = []
            for _ in range(chain):
                *state, m = cycle(*state, gen, 0.1)
                losses.append(m["loss"])
            return torch.stack(losses).sum()

        ms[li] = best_ms(cycles, args.reps, chain, dev)
    ms8, ms1 = ms[ITERS], ms[1]
    per_iter = (ms8 - ms1) / (ITERS - 1)
    front = ms1 - per_iter  # rollout + harvest + insert

    # Rollout only: chained raw fm kernel calls, fresh effective weights a generation like the cycle.
    params = state[0]
    play = make_act_rollout_kernel(cfg, games, hidden=H, feature_major=True)

    def rollout_chain():
        tot = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(chain):
            eff = noisy_effective_params(spec, params, draw_mlp_noise(spec, gen, batch=(T,)))
            seed = int(torch.randint(0, 2**31 - 1 - games // 1024, (1,), generator=gen, device=dev))
            _, _, rews = play(seed, eff["trunk"][0]["w"].contiguous(), eff["trunk"][0]["b"].contiguous(),
                              eff["heads"][1]["w"].contiguous(), eff["heads"][1]["b"].contiguous())
            tot = tot + rews.sum()
        return tot

    rollout_ms = best_ms(rollout_chain, args.reps, chain, dev)
    harvest_insert_ms = front - rollout_ms

    c = analytic_counts(T, P, S, games, H, A, N, CAP, MB, ITERS)
    phases = {
        "rollout": {
            "measured_ms": rollout_ms,
            "hbm_floor_ms": c["bytes_rollout"] / H100_HBM_BYTES_PER_S * 1e3,
            "f32_floor_ms": c["flops_rollout"] / H100_F32_FLOPS * 1e3,
            "floor_ms": floor_ms(c["bytes_rollout"], c["flops_rollout"]),
        },
        "harvest_insert": {
            "measured_ms": harvest_insert_ms,
            "hbm_floor_ms": c["bytes_insert"] / H100_HBM_BYTES_PER_S * 1e3,
            "floor_ms": floor_ms(c["bytes_insert"], 0),
        },
        "learn_8_updates": {
            "measured_ms": per_iter * ITERS,
            "per_update_ms": per_iter,
            "hbm_floor_ms": c["bytes_learn"] / H100_HBM_BYTES_PER_S * 1e3,
            "f32_floor_ms": c["flops_learn"] / H100_F32_FLOPS * 1e3,
            "floor_ms": floor_ms(c["bytes_learn"], c["flops_learn"]),
        },
    }
    for p in phases.values():
        p["bound_by"] = "bytes" if p["hbm_floor_ms"] >= p.get("f32_floor_ms", 0.0) else "operations"
        p["x_floor"] = p["measured_ms"] / p["floor_ms"]
    total_floor = sum(p["floor_ms"] for p in phases.values())
    binding = max(phases, key=lambda k: phases[k]["measured_ms"])
    b = phases[binding]
    result = {
        "config": {"games": games, "chain": chain, "reps": args.reps, "learn_iters": ITERS, "capacity": CAP,
                   "minibatch": MB, "compute_dtype": "float32"},
        "assumed_hw": {"card": smi_line() if dev.type == "cuda" else "cpu",
                       "hbm_bytes_per_s": H100_HBM_BYTES_PER_S, "f32_flops": H100_F32_FLOPS,
                       "bf16_tensor_core_flops": H100_BF16_TC_FLOPS},
        "counts": c,
        "measured_ms_per_cycle": {"full_8_iters": ms8, "one_iter": ms1},
        "phases": phases,
        "total_floor_ms": total_floor,
        "fraction_of_floor": total_floor / ms8,
        "headroom_x": ms8 / total_floor,
        "binding_constraint": (
            f"{binding}: {b['measured_ms']:.4f} of the cycle's {ms8:.4f} ms "
            f"({b['measured_ms'] / ms8:.1%}), {b['x_floor']:.0f}x its {b['bound_by']} floor of "
            f"{b['floor_ms']:.5f} ms; the whole cycle is {ms8 / total_floor:.0f}x the sum of the floors"),
    }
    print(json.dumps(result, indent=1))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
