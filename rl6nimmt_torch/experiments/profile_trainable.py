"""Decompose the trainable-cycle time: rollout vs buffer ops vs updates.

    python -m rl6nimmt_torch.experiments.profile_trainable [--games 4096] [--chain 16] [--iters 8]
        [--dtype float32|bfloat16] [--learners reinforce,dqn] [--device cuda]

Port of ``experiments/profile_trainable.py``: each component of the
REINFORCE and DQN cycles timed alone, as ``--chain`` steps between two
synchronizes with their state carried (params through updates, buffers
through adds) and a scalar of that state read on the host, the median of
``--iters`` chains after two untimed ones, per step.

* ``reinforce`` (the action-in-input net 48 -> 100 -> 100 -> (1), Adam
  1e-3): the rollout alone (its scores summed) and the fused train step;
* ``dqn`` (the flagship Noisy-D3QN-PER-10step cycle on the engine path, PER
  200,000, after 5 warm-up cycles that fill the buffer): (a) rollout +
  harvest + add (``learn_iters=0``), (b) the full cycle with 8 updates, (c)
  one bare Bellman update with its PER sample and priority write-back (the
  learn step built on the ``--dtype`` spec), (d) one PER sample alone.

``--dtype bfloat16`` sets the spec's ``compute_dtype`` (``nets/mlp.py``
``_mm``); as in JAX the DQN cycle builds its own float32 spec, so there it
reaches the bare update (c) only.  ``--iters`` (JAX: 8, fixed) only shortens
the run.  Prints JAX's JSON line a learner and returns ``{learner: line}``.
"""

from __future__ import annotations

import argparse
import json

import torch

CAP = 200_000


def profile_reinforce(cfg, G: int, n: int, dtype: str, iters: int, dev) -> dict:
    from ..agents.dqn import Adam
    from ..nets import MLPSpec, mlp_init
    from ..runtime.vector import make_reinforce_rollout, make_reinforce_train_step
    from .chain_timing import timed

    spec = MLPSpec(input_size=cfg.state_length + 1, hidden_sizes=(100, 100), head_sizes=(1,), compute_dtype=dtype)
    params = mlp_init(torch.Generator().manual_seed(0), spec, dev)
    optimizer = Adam(1e-3)
    opt_state = optimizer.init(params)
    gen = torch.Generator(device=dev).manual_seed(1)

    # Rollout only: the score total carried (actions depend on the forwards, rewards on the actions).
    rollout = make_reinforce_rollout(cfg, spec, G, dev)

    def roll_chain():
        tot = torch.zeros((), device=dev)
        for _ in range(n):
            tot = tot + rollout(params, gen)[1].to(torch.float32).sum()
        return tot

    t_roll = timed(roll_chain, dev, iters) / n

    # Full cycle: params and opt state carried through every update.
    train = make_reinforce_train_step(cfg, spec, optimizer, G, device=dev)
    carry = (params, opt_state)

    def full_chain():
        nonlocal carry
        for _ in range(n):
            carry = train(*carry, gen)[:2]
        return carry[0]["heads"][0]["b"].sum()      # the params' first leaf in JAX's order

    t_full = timed(full_chain, dev, iters) / n
    steps = G * cfg.max_turns
    line = {"learner": "reinforce", "dtype": dtype,
            "rollout_ms": round(t_roll * 1e3, 2),
            "full_cycle_ms": round(t_full * 1e3, 2),
            "lossgrad+update_ms": round((t_full - t_roll) * 1e3, 2),
            "steps_per_s_full": round(steps / t_full, 1)}
    print(json.dumps(line), flush=True)
    return line


def profile_dqn(cfg, G: int, n: int, dtype: str, iters: int, dev) -> dict:
    from ..agents.dqn import Adam, learn_noise, make_learn_step
    from ..buffers.per import per_sample, per_update
    from ..runtime.vector import make_dqn_selfplay_step
    from .chain_timing import flagship_cycle, timed

    cycle8, dqn_cfg, spec, (params, target, opt_state, buf) = flagship_cycle(cfg, G, dev, 8, CAP,
                                                                             compute_dtype=dtype)
    optimizer = Adam(1e-3)       # flagship_cycle's optimizer: a functional Adam holds no state
    gen = torch.Generator(device=dev).manual_seed(3)

    # Warm the buffer once (full + realistic priorities); the params are not carried, as in JAX.
    for _ in range(5):
        buf = cycle8(params, target, opt_state, buf, gen, 0.1)[3]

    # (a) rollout + harvest + buffer add, no updates.
    cycle0 = make_dqn_selfplay_step(cfg, dqn_cfg, optimizer, G, learn_iters=0, device=dev)

    def roll_chain():
        nonlocal buf
        for _ in range(n):
            buf = cycle0(params, target, opt_state, buf, gen, 0.1)[3]
        return buf.priorities[:1].sum()

    t_roll = timed(roll_chain, dev, iters) / n

    # (b) full cycle with the bench's learn_iters=8.
    carry = (params, target, opt_state, buf)

    def full_chain():
        nonlocal carry
        for _ in range(n):
            carry = cycle8(*carry, gen, 0.1)[:4]
        return carry[0]["heads"][0]["b"].sum()

    t_full = timed(full_chain, dev, iters) / n

    # (c) one bare Bellman update incl. PER sample + priority write-back, params AND priorities carried.
    learn_step = make_learn_step(dqn_cfg, spec, optimizer, 0.99)
    carry = (params, target, opt_state, buf)

    def upd_chain():
        nonlocal carry
        for _ in range(n):
            p, t_, o, b = carry
            b, idx, weights, batch = per_sample(b, torch.rand(dqn_cfg.minibatch, generator=gen, device=dev),
                                                dqn_cfg.minibatch)
            batch = {"state": batch["state"].to(torch.float32), "action": batch["action"].to(torch.int64),
                     "reward": batch["reward"], "next_state": batch["next_state"].to(torch.float32),
                     "done": batch["done"], "weights": weights}
            p, t_, o, loss, abs_err, _ = learn_step(p, t_, o, batch, True, noise=learn_noise(dqn_cfg, spec, gen))
            carry = (p, t_, o, per_update(b, idx, abs_err))
        return carry[0]["heads"][0]["b"].sum()

    t_upd = timed(upd_chain, dev, iters) / n

    # (d) PER sample alone (cumsum + search + gather), priorities carried.
    samp_buf = carry[3]

    def samp_chain():
        nonlocal samp_buf
        acc = torch.zeros((), device=dev)
        for _ in range(n):
            samp_buf, _, weights, batch = per_sample(samp_buf, torch.rand(dqn_cfg.minibatch, generator=gen,
                                                                          device=dev), dqn_cfg.minibatch)
            acc = acc + weights.sum() + batch["reward"].sum()
        return acc

    t_samp = timed(samp_chain, dev, iters) / n
    steps = G * cfg.max_turns
    line = {"learner": "dqn", "dtype": dtype, "capacity": CAP,
            "rollout+harvest+add_ms": round(t_roll * 1e3, 2),
            "full_cycle_ms": round(t_full * 1e3, 2),
            "8_updates_ms": round((t_full - t_roll) * 1e3, 2),
            "1_update_ms": round(t_upd * 1e3, 3),
            "1_per_sample_ms": round(t_samp * 1e3, 3),
            "steps_per_s_full": round(steps / t_full, 1)}
    print(json.dumps(line), flush=True)
    return line


def main(argv=None):
    from ..engine import EnvConfig
    from ..utils.device import resolve_device
    from .kernel_times import smi_line

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--games", type=int, default=4096)
    parser.add_argument("--chain", type=int, default=16)
    parser.add_argument("--iters", type=int, default=8, help="timed chains a component")
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--learners", default="reinforce,dqn")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = EnvConfig(num_players=4)
    profiles = {"reinforce": profile_reinforce, "dqn": profile_dqn}
    out = {name: profiles[name](cfg, args.games, args.chain, args.dtype, args.iters, dev)
           for name in args.learners.split(",")}
    print(json.dumps({"device": str(dev), "card": smi_line() if dev.type == "cuda" else "cpu"}), flush=True)
    return out


if __name__ == "__main__":
    main()
