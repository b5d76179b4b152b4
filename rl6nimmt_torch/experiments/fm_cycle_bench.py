"""The flagship cycle in each replay layout, arms interleaved per repeat.

    python -m rl6nimmt_torch.experiments.fm_cycle_bench [--games 4096] [--reps 3] [--chain 8]
        [--arms engine kernel kernel_fm kernel_fm_aligned insert] [--device cuda]

Port of ``experiments/fm_cycle_bench.py``, at ``bench.py``'s flagship
configuration: P=4, Noisy-D3QN-PER-10step with hidden 64, minibatch 64, 8
updates a cycle, Adam 1e-3, PER 200,000.  The arms:

* ``engine``: the engine rollout (K2 + K1), row-major ``per_init``;
* ``kernel``: K4 row-major, ``per_init``;
* ``kernel_fm``: K4 feature-major, ``per_init_fm(200_000)``;
* ``kernel_fm_aligned``: K4 feature-major, ``per_init_aligned_fm(200_000,
  G*T*P)`` (physical 327,680 at G=4096);
* ``insert``: K5, ``per_init_kd(204_800, 48, 8)``, the reference arm.

Each arm runs one cycle to warm up, then ``--reps`` timed runs of ``--chain``
cycles, the arms in turns within a repeat, each run ending with its losses on
the host (a host clock around work that ends on the host).  Prints one JSON
line an arm: ms a cycle (median run), env-steps/s, every run's seconds and the
kernel launches a cycle; then one line with the card's name and power limit.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

ARMS = ("engine", "kernel", "kernel_fm", "kernel_fm_aligned", "insert")
CAPACITY = 200_000
KD_CAPACITY = 204_800
LEARN_ITERS = 8
FLAGSHIP = dict(double=True, dueling=True, noisy=True, per=True, n_steps=10, hidden_sizes=(64,), minibatch=64)


def build(arm: str, cfg, num_games: int, dev, seed: int = 1):
    """``(cycle, state)`` of one arm: its cycle and a fresh ``(params, target,
    opt_state, buffer)`` from ``seed``."""
    from ..agents.dqn import Adam, DQNConfig, q_network_spec, tree_map
    from ..buffers import per_init, per_init_aligned_fm, per_init_fm, per_init_kd
    from ..nets import mlp_init
    from ..ops.act_rollout_kernel import S_PAD, SCAL_ROWS
    from ..runtime.vector import dqn_replay_example, make_dqn_selfplay_step

    if arm not in ARMS:
        raise ValueError(f"unknown arm {arm!r}; choose from {ARMS}")
    dqn = DQNConfig(**FLAGSHIP)
    spec = q_network_spec(dqn, cfg.state_length, cfg.num_actions)
    params = mlp_init(torch.Generator(device=dev).manual_seed(seed), spec, dev)
    adam = Adam(1e-3)
    example = dqn_replay_example(cfg)
    block = num_games * cfg.max_turns * cfg.num_players
    buffers = {"engine": lambda: per_init(CAPACITY, example, device=dev),
               "kernel": lambda: per_init(CAPACITY, example, device=dev),
               "kernel_fm": lambda: per_init_fm(CAPACITY, example, device=dev),
               "kernel_fm_aligned": lambda: per_init_aligned_fm(CAPACITY, block, example, device=dev),
               "insert": lambda: per_init_kd(KD_CAPACITY, S_PAD, SCAL_ROWS, device=dev)}
    options = {"engine": {}, "kernel": dict(kernel_act_rollout=True),
               "kernel_fm": dict(kernel_act_rollout=True, feature_major=True),
               "kernel_fm_aligned": dict(kernel_act_rollout=True, feature_major=True,
                                         per_aligned_capacity=CAPACITY),
               "insert": dict(kernel_insert=True)}
    cycle = make_dqn_selfplay_step(cfg, dqn, adam, num_games, learn_iters=LEARN_ITERS, device=dev, **options[arm])
    return cycle, (params, tree_map(torch.clone, params), adam.init(params), buffers[arm]())


def run_chain(cycle, state, gen, chain: int, step0: int, eps: float = 0.1):
    """``chain`` cycles from ``state``; returns the new state and the losses on the host."""
    losses = []
    for c in range(chain):
        *state, m = cycle(*state, gen, eps, step0 + c * LEARN_ITERS)
        losses.append(m["loss"])
    return tuple(state), torch.stack(losses).cpu()


def main(argv=None):
    from ..engine import EnvConfig
    from ..ops import _build
    from ..utils.device import resolve_device, synchronize
    from .kernel_times import smi_line

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--games", type=int, default=4096)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--chain", type=int, default=8, help="cycles a timed run")
    parser.add_argument("--arms", nargs="+", default=list(ARMS), choices=ARMS)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = EnvConfig(num_players=4)
    arms, states, gens, launches, steps = {}, {}, {}, {}, {}
    for arm in args.arms:
        cycle, state = build(arm, cfg, args.games, dev, args.seed + 1)
        gens[arm] = torch.Generator(device=dev).manual_seed(args.seed + 10)
        before = dict(_build.LAUNCHES)
        state, losses = run_chain(cycle, state, gens[arm], 1, 0)       # warm-up
        launches[arm] = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
        if not all(math.isfinite(x) for x in losses.tolist()):
            raise AssertionError(f"{arm}: non-finite loss {losses.tolist()}")
        arms[arm], states[arm], steps[arm] = cycle, state, LEARN_ITERS

    times = {arm: [] for arm in arms}
    for _ in range(args.reps):
        for arm, cycle in arms.items():              # in turns: the host's speed drifts
            synchronize(dev)
            t0 = time.perf_counter()
            states[arm], losses = run_chain(cycle, states[arm], gens[arm], args.chain, steps[arm])
            times[arm].append(time.perf_counter() - t0)
            steps[arm] += args.chain * LEARN_ITERS
            if not all(math.isfinite(x) for x in losses.tolist()):
                raise AssertionError(f"{arm}: non-finite loss {losses.tolist()}")

    result = {}
    env_steps = args.games * cfg.max_turns * args.chain
    for arm, ts in times.items():
        med = sorted(ts)[len(ts) // 2]
        buf = states[arm][3]
        result[arm] = {"ms_per_cycle": med / args.chain * 1e3, "env_steps_per_s": env_steps / med,
                       "all_s": ts, "launches_per_cycle": launches[arm], "per_size": buf.size, "per_ptr": buf.ptr,
                       "per_physical_capacity": buf.capacity}
        print(json.dumps({"fm_cycle_bench": arm, "games": args.games, "chain": args.chain, "reps": args.reps,
                          **result[arm]}), flush=True)
    print(json.dumps({"device": str(dev), "card": smi_line() if dev.type == "cuda" else "cpu"}), flush=True)
    return result


if __name__ == "__main__":
    main()
