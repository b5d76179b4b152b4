"""Micro-timings of per_sample internals on the current device.

    python -m rl6nimmt_torch.experiments.micro_per [--chain 64] [--iters 8] [--device cuda]

Port of ``experiments/micro_per.py``: a full PER buffer of 200,000 float32
transitions (47 features) with priorities ``U[0, 1) + 0.01`` from
``RandomState(0)``, and seven probes of a 64-row sample: the cumsum of the
priorities, the blocked index resolution (``buffers/per.py``
``_stratified_indices``), a flat cumsum + searchsorted, the masked min (the
weights' denominator), a 64-row storage gather, ``per_sample`` on a fixed
buffer and ``per_sample`` with the buffer carried from call to call (its
beta anneals).  Each is ``--chain`` calls between two synchronizes, the
median of ``--iters`` chains after two untimed ones (``chain_timing``), in ms
a call; every draw comes from one generator seeded 0.  No kernel of the port
runs.  The JAX script had no flags; these two only shorten the run.  Returns
``{probe: ms}``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

CAP = 200_000
N = 64
CHAIN = 64
ITERS = 8


def main(argv=None):
    from ..buffers import per_init
    from ..buffers.per import _stratified_indices, per_sample
    from ..utils.device import resolve_device
    from .chain_timing import timed

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chain", type=int, default=CHAIN, help="calls a timed chain")
    parser.add_argument("--iters", type=int, default=ITERS, help="timed chains a probe")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    pri = torch.as_tensor(np.random.RandomState(0).random(CAP).astype(np.float32) + 0.01, device=dev)
    example = {"state": torch.zeros(47), "action": torch.zeros((), dtype=torch.int32), "reward": torch.zeros(()),
               "next_state": torch.zeros(47), "done": torch.zeros(())}
    buf = per_init(CAP, example, dev)
    buf.priorities.copy_(pri)
    buf.size = CAP
    gen = torch.Generator(device=dev).manual_seed(0)
    uniform = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    out = {}

    def probe(label, body):
        def chained():
            acc = torch.zeros((), device=dev)
            for _ in range(args.chain):
                acc = acc + body()
            return acc

        out[label] = timed(chained, dev, args.iters) / args.chain * 1e3
        print(f"{label + ':':<24}{out[label]:.3f} ms", flush=True)

    # 1. cumsum alone
    probe("cumsum 200k", lambda: torch.cumsum(pri, 0)[-1])
    # 2. blocked index resolution alone
    probe("blocked indices",
          lambda: _stratified_indices(pri, uniform(N) * pri.sum()).to(torch.float32).sum())
    # 3. flat searchsorted resolution
    probe("cumsum+searchsorted",
          lambda: torch.searchsorted(torch.cumsum(pri, 0), uniform(N) * pri.sum()).to(torch.float32).sum())
    # 4. min-over-valid reduce (weights denominator)
    valid = torch.arange(CAP, device=dev) < buf.size
    probe("masked min reduce", lambda: torch.where(valid, pri, torch.inf).min() + uniform(1)[0])

    # 5. storage gather of 64 rows
    def gath():
        idx = torch.randint(0, CAP, (N,), generator=gen, device=dev)
        b = {k: s[idx] for k, s in buf.storage.items()}
        return b["state"].sum() + b["next_state"].sum()
    probe("storage gather 64 rows", gath)

    # 6. full per_sample (fixed buf, no carry)
    def full():
        _, _, w, batch = per_sample(buf, uniform(N), N)
        return w.sum() + batch["state"].sum()
    probe("full per_sample", full)

    # 7. per_sample with buf CARRIED from call to call (as in the cycle)
    carried_buf = buf

    def carried():
        nonlocal carried_buf
        carried_buf, _, w, batch = per_sample(carried_buf, uniform(N), N)
        return w.sum() + batch["state"].sum()
    probe("per_sample carried buf", carried)
    return out


if __name__ == "__main__":
    main()
