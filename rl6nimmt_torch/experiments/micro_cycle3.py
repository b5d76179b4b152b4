"""Decomposition of the DQN cycle: act-rollout vs harvest vs scatter.

    python -m rl6nimmt_torch.experiments.micro_cycle3 [--chain 16] [--iters 6] [--games 4096] [--device cuda]

Port of ``experiments/micro_cycle3.py``, on the flagship configuration (P=4,
Noisy-D3QN-PER-10step, hidden 64, PER 200,000).  Four probes, each read on
the host from outputs that depend on all the work it claims:

(a) the act-rollout alone: the engine's ``deal`` (K2), then per turn
    ``observe``, the noisy ``q_values`` on a fresh noise draw, the legal
    argmax and ``step`` (K1); probe rewards + actions + 1e-9 x observations;
(b) rollout + harvest + PER add (``make_dqn_selfplay_step`` with
    ``learn_iters=0``); probe priorities + stored rewards + ``state[:, 0]``;
(c) the PER add of 163,840 fixed transitions alone, at a random ptr;
(d) the raw uniform-legal random rollout on the engine.

Each is ``--chain`` calls between two synchronizes, the median of
``--iters`` chains after two untimed ones (``chain_timing``), in ms a call.
The JAX script ran at module level with no flags; these three only shorten
the run.  Returns ``{probe: ms}``.
"""

from __future__ import annotations

import argparse

import torch

G = 4096
CAP = 200_000
CHAIN = 16
ITERS = 6
N_FIXED = 163_840
NEG_INF = -1e9


def rollout(cfg, dqn_cfg, spec, params, games: int, gen):
    """The noisy greedy rollout of the JAX script's ``rollout``: ``(obs,
    actions, rewards, next_obs, scores)``, each turn on a fresh noise draw."""
    from ..agents.dqn import q_values
    from ..engine import deal, observe, step
    from ..nets import draw_mlp_noise

    dev = gen.device
    state = deal(cfg, int(torch.randint(0, 2**62, (1,), generator=gen, device=dev)), games, device=dev)
    obs_l, act_l, rew_l = [], [], []
    for _ in range(cfg.max_turns):
        obs, masks = observe(cfg, state)
        q = q_values(dqn_cfg, spec, params, obs, draw_mlp_noise(spec, gen))
        actions = torch.argmax(torch.where(masks, q, NEG_INF), dim=-1).to(torch.int32)
        state, rewards = step(cfg, state, actions)
        obs_l.append(obs)
        act_l.append(actions)
        rew_l.append(rewards.to(torch.float32))
    final_obs, _ = observe(cfg, state)
    obs = torch.stack(obs_l)
    next_obs = torch.cat([obs[1:], final_obs[None]], dim=0)
    return obs, torch.stack(act_l), torch.stack(rew_l), next_obs, -state.scores


def raw_rollout(cfg, games: int, gen):
    """Uniform-legal random play on the engine; the probe is rewards + 1e-9 x observations."""
    from ..engine import deal, observe, step
    from ..utils.ops import onehot_select, uniform_index

    dev = gen.device
    state = deal(cfg, int(torch.randint(0, 2**62, (1,), generator=gen, device=dev)), games, device=dev)
    probe = torch.zeros((), device=dev)
    for _ in range(cfg.max_turns):
        obs, _ = observe(cfg, state)
        hs = state.hands_sorted
        r = uniform_index(torch.rand(hs.shape[:2], generator=gen, device=dev), (hs >= 0).sum(dim=-1))
        state, rewards = step(cfg, state, onehot_select(hs, r).to(torch.int32))
        probe = probe + rewards.sum() + obs.sum() * 1e-9
    return probe


def main(argv=None):
    import dataclasses

    from ..buffers import per_add_batch
    from ..engine import EnvConfig
    from ..utils.device import resolve_device
    from .chain_timing import flagship_cycle, timed

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chain", type=int, default=CHAIN, help="calls a timed chain")
    parser.add_argument("--iters", type=int, default=ITERS, help="timed chains a probe")
    parser.add_argument("--games", type=int, default=G)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = EnvConfig(num_players=4)
    cycle0, dqn_cfg, spec, (params, target, opt_state, buf0) = flagship_cycle(cfg, args.games, dev, 0, CAP)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def probe(label, one):
        def chained():
            acc = torch.zeros((), device=dev)
            for _ in range(args.chain):
                acc = acc + one()
            return acc

        out[label] = timed(chained, dev, args.iters) / args.chain * 1e3
        print(f"{label + ':':<35}{out[label]:7.2f} ms", flush=True)

    # (a) act-rollout only
    def roll_only():
        obs, actions, rewards, _, _ = rollout(cfg, dqn_cfg, spec, params, args.games, gen)
        return rewards.sum() + actions.to(torch.float32).sum() + obs.sum() * 1e-9
    probe("act-rollout only", roll_only)

    # (b) rollout + harvest + PER add
    def roll_add():
        b = cycle0(params, target, opt_state, buf0, gen, 0.1)[3]
        return b.priorities.sum() + b.storage["reward"].sum() + b.storage["state"][:, 0].sum()
    probe("rollout+harvest+add", roll_add)

    # (c) scatter alone: fixed transitions, a fresh add at a random ptr each call
    S = cfg.state_length
    fixed = {"state": torch.ones((N_FIXED, S), device=dev), "reward": torch.ones(N_FIXED, device=dev),
             "action": torch.ones(N_FIXED, dtype=torch.int32, device=dev),
             "next_state": torch.ones((N_FIXED, S), device=dev), "done": torch.zeros(N_FIXED, device=dev)}

    def add_only():
        ptr = int(torch.randint(0, CAP, (1,), generator=gen, device=dev))
        b = per_add_batch(dataclasses.replace(buf0, ptr=ptr), fixed)
        return b.priorities.sum() + b.storage["state"][:, 0].sum()
    probe(f"PER add_batch ({N_FIXED} rows) alone", add_only)

    # (d) raw random rollout engine reference point
    probe("raw random rollout (XLA engine)", lambda: raw_rollout(cfg, args.games, gen))
    return out


if __name__ == "__main__":
    main()
