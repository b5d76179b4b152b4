"""Localize the fixed cost of attaching one update to the DQN cycle.

    python -m rl6nimmt_torch.experiments.micro_cycle2 [--chain 16] [--iters 6] [--games 4096] [--device cuda]

Port of ``experiments/micro_cycle2.py``: nine variants of the flagship cycle
(P=4, Noisy-D3QN-PER-10step, hidden 64, minibatch 64, PER 200,000, the
engine rollout), each timed as ``--chain`` cycles between two synchronizes,
the median of ``--iters`` chains after two untimed ones, in ms a cycle.
``--games`` replaces the default G=4096; the rows that name their own G keep
it.  The two ``cap=16384, G=1024`` rows insert 40,960 transitions a cycle
into 16,384 slots, which ``per_add_batch`` refuses in both packages: the JAX
script died there; the twin prints the row's error and goes on
(``PARITY_TORCH.md`` section 20).  Returns ``{row: ms a cycle or the error}``.
"""

from __future__ import annotations

import argparse

G = 4096
CHAIN = 16
ITERS = 6
# (tag, games or None for --games, capacity, learn_iters, DQNConfig overrides): experiments/micro_cycle2.py:73-81
ROWS = (
    ("baseline G=4096 li=1", None, 200_000, 1, {}),
    ("li=0", None, 200_000, 0, {}),
    ("G=512 li=1", 512, 200_000, 1, {}),
    ("G=512 li=0", 512, 200_000, 0, {}),
    ("noisy=False li=1", None, 200_000, 1, {"noisy": False}),
    ("n_steps=1 li=1", None, 200_000, 1, {"n_steps": 1}),
    ("minibatch=1024 li=1", None, 200_000, 1, {"minibatch": 1024}),
    ("cap=16384 li=1 (fits VMEM-ish)", 1024, 16_384, 1, {}),
    ("cap=16384 li=0", 1024, 16_384, 0, {}),
)


def run(cfg, tag: str, games: int, cap: int, li: int, overrides: dict, chain: int, iters: int, dev):
    """ms a cycle of one row; a ``ValueError`` of the cycle (the over-capacity
    insert) is printed and returned as its message."""
    import torch

    from .chain_timing import flagship_cycle, run_cycles, timed

    cycle, _, _, state = flagship_cycle(cfg, games, dev, li, capacity=cap, **overrides)
    gen = torch.Generator(device=dev).manual_seed(0)

    def chained():
        nonlocal state
        state, _ = run_cycles(cycle, state, gen, chain)
        return state[0]["heads"][0]["b"].sum()

    try:
        t = timed(chained, dev, iters) / chain
    except ValueError as err:
        print(f"{tag:<42} raised: {err}", flush=True)
        return f"ValueError: {err}"
    print(f"{tag:<42} {t*1e3:7.2f} ms/cycle", flush=True)
    return t * 1e3


def main(argv=None):
    from ..engine import EnvConfig
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chain", type=int, default=CHAIN, help="cycles a timed chain")
    parser.add_argument("--iters", type=int, default=ITERS, help="timed chains a row")
    parser.add_argument("--games", type=int, default=G, help="G of the rows that do not name theirs")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = EnvConfig(num_players=4)
    return {tag: run(cfg, tag, games or args.games, cap, li, kw, args.chain, args.iters, dev)
            for tag, games, cap, li, kw in ROWS}


if __name__ == "__main__":
    main()
