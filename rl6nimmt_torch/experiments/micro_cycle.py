"""Sweep learn_iters in the DQN cycle: where do the update milliseconds go?

    python -m rl6nimmt_torch.experiments.micro_cycle [--chain 16] [--iters 6] [--games 4096] [--device cuda]

Port of ``experiments/micro_cycle.py``: the flagship cycle (P=4,
Noisy-D3QN-PER-10step, hidden 64, minibatch 64, Adam 1e-3, the engine
rollout: K2 once and K1 ten times a cycle) at learn_iters 0, 1, 2, 4 and 8
on PER 200,000, then 8 updates on the ring instead of PER, then on PER
50,000.  Each row times ``--chain`` cycles between two synchronizes
(``chain_timing``), the median of ``--iters`` chains after two untimed ones,
and prints ms a cycle.  At G=4096 the last row inserts 163,840 transitions a
cycle into 50,000 slots, which ``per_add_batch`` refuses in both packages:
the JAX script died there; the twin prints the row's error and returns it
(``PARITY_TORCH.md`` section 20).  The JAX script ran at module level with
no flags; these three only shorten the run.  Returns ``{row: ms a cycle or
the error}``.
"""

from __future__ import annotations

import argparse

G = 4096
CHAIN = 16
ITERS = 6
ROWS = tuple((True, 200_000, li) for li in (0, 1, 2, 4, 8)) + ((False, 200_000, 8), (True, 50_000, 8))


def run(cfg, games: int, per: bool, cap: int, learn_iters: int, chain: int, iters: int, dev) -> float:
    import torch

    from .chain_timing import flagship_cycle, run_cycles, timed

    cycle, _, _, state = flagship_cycle(cfg, games, dev, learn_iters, capacity=cap, per=per)
    gen = torch.Generator(device=dev).manual_seed(0)

    def chained():
        nonlocal state
        state, _ = run_cycles(cycle, state, gen, chain)
        return state[0]["heads"][0]["b"].sum()          # the params' first leaf in JAX's order, its probe

    try:
        t = timed(chained, dev, iters) / chain
    except ValueError as err:       # a cycle's insert larger than the buffer
        print(f"per={per} cap={cap:>7} learn_iters={learn_iters}: raised: {err}", flush=True)
        return f"ValueError: {err}"
    print(f"per={per} cap={cap:>7} learn_iters={learn_iters}: {t*1e3:7.2f} ms/cycle", flush=True)
    return t * 1e3


def main(argv=None):
    from ..engine import EnvConfig
    from ..utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chain", type=int, default=CHAIN, help="cycles a timed chain")
    parser.add_argument("--iters", type=int, default=ITERS, help="timed chains a row")
    parser.add_argument("--games", type=int, default=G)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = EnvConfig(num_players=4)
    return {f"per={per} cap={cap} learn_iters={li}": run(cfg, args.games, per, cap, li, args.chain, args.iters, dev)
            for per, cap, li in ROWS}


if __name__ == "__main__":
    main()
