"""Decompose the ACER selfplay cycle: rollout vs store vs on/off-policy train.

    python -m rl6nimmt_torch.experiments.micro_acer [--chain 16] [--iters 6] [--games 4096] [--device cuda]

Port of ``experiments/micro_acer.py``: the action-in-input actor-critic
net 48 -> 100 -> 100 -> (1, 1) from seed 2, Adam 1e-3, G=4096 games at P=4.
Three probes, each ``--chain`` calls between two synchronizes, the median of
``--iters`` chains after two untimed ones (``chain_timing``), in ms a call:

(a) the ACER rollout alone (``make_acer_rollout``, r_factor 0.1: K2 once and
    K1 ten times), probed by its scores and rewards;
(b) the on-policy train step (``make_acer_train_step``: gamma 0.99,
    truncation 1, actor and critic weights 1) on one fixed batch of G*P fresh
    sequences (16,384 at G=4096), the params carried;
(c) the off-policy train step on 512 sequences sampled uniformly from a
    65,536-sequence buffer holding that batch, the params carried.

The JAX script had no flags; these three only shorten the run.  Returns
``{probe: ms}``.
"""

from __future__ import annotations

import argparse

import torch

G = 4096
CHAIN = 16
ITERS = 6
CAPACITY = 65_536
OFF_POLICY = 512


def main(argv=None):
    from ..agents.acer import make_acer_train_step
    from ..agents.dqn import Adam
    from ..buffers import seq_init
    from ..buffers.sequence import seq_sample, seq_store_batch
    from ..engine import EnvConfig
    from ..nets import MLPSpec, mlp_init
    from ..runtime.vector import acer_sequence_example, make_acer_rollout
    from ..utils.device import resolve_device
    from .chain_timing import timed

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chain", type=int, default=CHAIN, help="calls a timed chain")
    parser.add_argument("--iters", type=int, default=ITERS, help="timed chains a probe")
    parser.add_argument("--games", type=int, default=G)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = EnvConfig(num_players=4)
    spec = MLPSpec(input_size=1 + cfg.state_length, hidden_sizes=(100, 100), head_sizes=(1, 1))
    params = mlp_init(torch.Generator(device=dev).manual_seed(2), spec, dev)
    optimizer = Adam(1e-3)
    opt_state = optimizer.init(params)
    buf = seq_init(CAPACITY, cfg.max_turns, acer_sequence_example(cfg), device=dev)
    rollout = make_acer_rollout(cfg, spec, args.games, r_factor=0.1, device=dev)
    train = make_acer_train_step(spec, optimizer, 0.99, 1.0, 1.0, 1.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def probe(label, body):
        def chained():
            acc = torch.zeros((), device=dev)
            for _ in range(args.chain):
                acc = acc + body()
            return acc

        out[label] = timed(chained, dev, args.iters) / args.chain * 1e3
        print(f"{label + ':':<29}{out[label]:7.2f} ms", flush=True)

    # (a) rollout only
    def roll_only():
        seqs, scores = rollout(params, gen)
        return scores.to(torch.float32).sum() + seqs["reward"].sum()
    probe("rollout only", roll_only)

    # (b) on-policy train on a fixed fresh batch (params carried)
    seqs_fixed, _ = rollout(params, torch.Generator(device=dev).manual_seed(9))
    state = (params, opt_state)

    def on_policy():
        nonlocal state
        p, o, _ = train(*state, seqs_fixed)
        state = (p, o)
        return p["heads"][0]["b"].sum()          # the params' first leaf in JAX's order
    probe(f"on-policy train ({seqs_fixed['length'].shape[0]} seq)", on_policy)

    # (c) off-policy train on 512 sampled sequences (params carried)
    buf = seq_store_batch(buf, {k: v for k, v in seqs_fixed.items() if k != "length"}, seqs_fixed["length"])
    state = (params, opt_state)

    def off_policy():
        nonlocal state
        _, batch, lengths = seq_sample(buf, OFF_POLICY, generator=gen)
        p, o, _ = train(*state, dict(batch, length=lengths))
        state = (p, o)
        return p["heads"][0]["b"].sum()
    probe(f"off-policy train ({OFF_POLICY} seq)", off_policy)
    return out


if __name__ == "__main__":
    main()
