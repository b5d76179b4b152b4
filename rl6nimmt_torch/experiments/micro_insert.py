"""The PER batch insert alone: the wrapping ring against the block-aligned layout,
row-major and feature-major.

    python -m rl6nimmt_torch.experiments.micro_insert [--chain 64] [--reps 5] [--device cuda]

Port of ``experiments/micro_insert.py``: 163,840 transitions a cycle (G=4096,
P=4, T=10) into a 200,000-slot buffer of f32 states (47 features), the
flagship trainer's insert.  Four arms: ``per_add_batch`` into ``per_init``
(ring, row-major), ``per_add_batch_aligned`` into ``per_init_aligned``
(physical 327,680), and both again feature-major (``per_init_fm``,
``per_init_aligned_fm``, ``slot_axis=-1``).  Each arm times ``--chain``
inserts back to back between two CUDA events (the reward shifted every
insert, as the JAX script does against common-subexpression elimination) and
keeps the best of ``--reps`` runs.  Prints one JSON line an arm (ms an
insert, the physical capacity, the final ptr and size), the aligned-over-ring
ratios and the card's name and power limit.  On ``--device cpu`` it times
with the host clock instead.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

G, P, T = 4096, 4, 10
N = G * P * T            # 163,840
CAPACITY = 200_000
S = 47
ARMS = ("ring", "aligned", "ring_fm", "aligned_fm")


def arms(n: int, capacity: int, dev):
    """``{arm: (buffer, insert(buffer, items) -> buffer, feature_major)}``."""
    from ..buffers import (per_add_batch, per_add_batch_aligned, per_init, per_init_aligned, per_init_aligned_fm,
                           per_init_fm)

    example = {"state": torch.zeros(S), "action": torch.zeros((), dtype=torch.int32), "reward": torch.zeros(()),
               "next_state": torch.zeros(S), "done": torch.zeros(())}
    return {
        "ring": (per_init(capacity, example, dev), per_add_batch, False),
        "aligned": (per_init_aligned(capacity, n, example, dev),
                    lambda b, it: per_add_batch_aligned(b, it, capacity), False),
        "ring_fm": (per_init_fm(capacity, example, dev), lambda b, it: per_add_batch(b, it, slot_axis=-1), True),
        "aligned_fm": (per_init_aligned_fm(capacity, n, example, dev),
                       lambda b, it: per_add_batch_aligned(b, it, capacity, slot_axis=-1), True),
    }


def items_of(n: int, feature_major: bool, dev) -> dict:
    state = torch.ones((S, n) if feature_major else (n, S), device=dev)
    return {"state": state, "action": torch.ones(n, dtype=torch.int32, device=dev),
            "reward": torch.ones(n, device=dev), "next_state": state.clone(), "done": torch.zeros(n, device=dev)}


def time_arm(buf, insert, items, chain: int, reps: int, dev):
    """Best ms an insert over ``reps`` runs of ``chain`` inserts; returns it and the buffer."""
    cuda = dev.type == "cuda"
    buf = insert(buf, items)            # warm-up
    best = float("inf")
    for _ in range(reps):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for i in range(chain):
            buf = insert(buf, dict(items, reward=items["reward"] + i))
        if cuda:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / chain)
    return best, buf


def main(argv=None):
    from ..utils.device import resolve_device
    from .kernel_times import smi_line

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chain", type=int, default=64)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--n", type=int, default=N, help="transitions an insert")
    parser.add_argument("--capacity", type=int, default=CAPACITY)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    result = {}
    for arm, (buf, insert, fm) in arms(args.n, args.capacity, dev).items():
        ms, buf = time_arm(buf, insert, items_of(args.n, fm, dev), args.chain, args.reps, dev)
        inserted = (1 + args.chain * args.reps) * args.n
        if buf.size != min(inserted, args.capacity):
            raise AssertionError(f"{arm}: size {buf.size} after {inserted} transitions")
        if int((buf.priorities > 0).sum()) != buf.size:
            raise AssertionError(f"{arm}: the live slots are not the newest {buf.size}")
        result[arm] = {"ms_per_insert": ms, "physical_capacity": buf.capacity, "ptr": buf.ptr, "size": buf.size}
        print(json.dumps({"micro_insert": arm, "n": args.n, "capacity": args.capacity, "chain": args.chain,
                          "clock": "cuda events" if dev.type == "cuda" else "host", **result[arm]}), flush=True)
    ratios = {f"{a}_over_{r}": result[a]["ms_per_insert"] / result[r]["ms_per_insert"]
              for a, r in (("aligned", "ring"), ("aligned_fm", "ring_fm"), ("ring_fm", "ring"))}
    print(json.dumps({"ratios": ratios, "device": str(dev), "card": smi_line() if dev.type == "cuda" else "cpu"}),
          flush=True)
    return result


if __name__ == "__main__":
    main()
