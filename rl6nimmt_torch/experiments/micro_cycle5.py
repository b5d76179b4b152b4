"""DQN-cycle decomposition on effective weights, ring against block-aligned PER.

    python -m rl6nimmt_torch.experiments.micro_cycle5 [--chain 32] [--iters 6] [--games 4096] [--device cuda]

Port of ``experiments/micro_cycle5.py`` on the flagship configuration (P=4,
Noisy-D3QN-PER-10step, hidden 64, minibatch 64, Adam 1e-3, the engine path:
K2 once and K1 ten times a rollout).  Two rollouts on the cycle's per-turn
effective weights (``noisy_effective_params`` of one draw of T turns'
noise), ``no_act`` (uniform-legal picks) and ``full_act`` (the greedy net),
each probed by its observations, rewards and final scores; then the cycle at
learn_iters 0 and 8 on the ring (``per_init(200_000)``) and on the
block-aligned layout (``per_aligned_capacity=200_000`` on
``per_init_aligned(200_000, T*G*P)``), probed by its mean scores, one
priority and a bias.  Each row is ``--chain`` calls between two
synchronizes, the median of ``--iters`` after one untimed chain, in ms a
cycle.  The JAX script had no flags; these three only shorten the run.
Returns ``{row: ms}``.
"""

from __future__ import annotations

import argparse

import torch

G = 4096
CHAIN = 32
ITERS = 6
CAPACITY = 200_000
NEG_INF = -1e9


def rollout_one(kind: str, cfg, dqn_cfg, spec, params, games: int, gen):
    """One rollout of ``kind`` (``no_act`` or ``full_act``) on per-turn effective weights; its probe."""
    import dataclasses

    from ..agents.dqn import q_values
    from ..engine import deal, observe, step
    from ..nets import draw_mlp_noise, noisy_effective_params
    from ..ops.act_rollout_check import turn_slice
    from ..utils.ops import onehot_select, uniform_index

    dev = gen.device
    T = cfg.max_turns
    state = deal(cfg, int(torch.randint(0, 2**62, (1,), generator=gen, device=dev)), games, device=dev)
    eff = noisy_effective_params(spec, params, draw_mlp_noise(spec, gen, batch=(T,)))
    eff_spec = dataclasses.replace(spec, noisy=False)
    o_sum = r_sum = torch.zeros((), device=dev)
    for t in range(T):
        obs, masks = observe(cfg, state)
        if kind == "no_act":
            hs = state.hands_sorted
            r = uniform_index(torch.rand(hs.shape[:2], generator=gen, device=dev), (hs >= 0).sum(dim=-1))
            actions = onehot_select(hs, r)
        else:
            q = q_values(dqn_cfg, eff_spec, turn_slice(eff, t), obs)
            actions = torch.argmax(torch.where(masks, q, NEG_INF), dim=-1)
        state, rewards = step(cfg, state, actions.to(torch.int32))
        o_sum, r_sum = o_sum + obs.sum(), r_sum + rewards.sum()
    return o_sum + r_sum - state.scores.sum()


def cycle_variant(cfg, games: int, learn_iters: int, aligned: bool, dev):
    """The cycle and a fresh state on the ring or the block-aligned buffer."""
    from ..agents.dqn import Adam, DQNConfig, q_network_spec, tree_map
    from ..buffers import per_init, per_init_aligned
    from ..nets import mlp_init
    from ..runtime.vector import make_dqn_selfplay_step
    from .chain_timing import FLAGSHIP, replay_example

    dqn = DQNConfig(**FLAGSHIP)
    spec = q_network_spec(dqn, cfg.state_length, cfg.num_actions)
    adam = Adam(1e-3)
    cycle = make_dqn_selfplay_step(cfg, dqn, adam, games, learn_iters=learn_iters,
                                   per_aligned_capacity=CAPACITY if aligned else None, device=dev)
    p = mlp_init(torch.Generator(device=dev).manual_seed(1), spec, dev)
    block = cfg.max_turns * games * cfg.num_players
    buf = (per_init_aligned(CAPACITY, block, replay_example(cfg), dev) if aligned
           else per_init(CAPACITY, replay_example(cfg), dev))
    return cycle, (p, tree_map(torch.clone, p), adam.init(p), buf)


def main(argv=None):
    from ..engine import EnvConfig
    from ..utils.device import resolve_device
    from .chain_timing import flagship_cycle, run_cycles
    from .micro_cycle4 import timeit

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chain", type=int, default=CHAIN, help="calls a timed chain")
    parser.add_argument("--iters", type=int, default=ITERS, help="timed chains a row")
    parser.add_argument("--games", type=int, default=G)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = EnvConfig(num_players=4)
    _, dqn_cfg, spec, (params, *_) = flagship_cycle(cfg, args.games, dev, 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for kind in ("no_act", "full_act"):
        out[f"rollout[{kind}]"] = ms = timeit(
            lambda: rollout_one(kind, cfg, dqn_cfg, spec, params, args.games, gen), args.chain, args.iters, dev)
        print(f"rollout[{kind:8s}]           : {ms:6.2f} ms/cycle", flush=True)

    for aligned in (False, True):
        for iters in (0, 8):
            cycle, state = cycle_variant(cfg, args.games, iters, aligned, dev)

            def one():
                nonlocal state
                state, (m,) = run_cycles(cycle, state, gen, 1)
                return m["mean_score"] + state[3].priorities[:1].sum() + state[0]["trunk"][0]["b"].sum()

            lay = "aligned" if aligned else "ring   "
            out[f"cycle[{lay.strip()}, learn_iters={iters}]"] = ms = timeit(one, args.chain, args.iters, dev)
            print(f"cycle[{lay}, learn_iters={iters}]: {ms:6.2f} ms/cycle", flush=True)
    return out


if __name__ == "__main__":
    main()
