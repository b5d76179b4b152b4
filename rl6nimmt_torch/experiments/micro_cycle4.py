"""DQN-cycle decomposition: rollout variants and cycles by learn_iters.

    python -m rl6nimmt_torch.experiments.micro_cycle4 [--chain 16] [--iters 6] [--games 4096] [--device cuda]

Port of ``experiments/micro_cycle4.py`` on the flagship configuration (P=4,
Noisy-D3QN-PER-10step, hidden 64, minibatch 64, the engine path: K2 once and
K1 ten times a rollout).  Four rollouts, each probed by its rewards (and the
observations where the net does not read them):

* ``no_act``: uniform-legal picks (``uniform_index`` + ``onehot_select``) in
  place of the net;
* ``mean_net``: the greedy net with no noise;
* ``no_obs_net``: the noisy net on an all-zero observation;
* ``full_act``: the noisy net on the observation (a fresh draw a turn).

Then the full cycle (PER 200,000, Adam 1e-3) at learn_iters 1 and 8; the JAX
script skips its learn_iters=0 row (``continue``), and so does the twin.
Each row is ``--chain`` calls between two synchronizes, the median of
``--iters`` after one untimed call, in ms a cycle.  The JAX script had no
flags; these three only shorten the run.  Returns ``{row: ms}``.
"""

from __future__ import annotations

import argparse

import torch

G = 4096
CHAIN = 16
ITERS = 6
KINDS = ("no_act", "mean_net", "no_obs_net", "full_act")
NEG_INF = -1e9


def rollout_one(kind: str, cfg, dqn_cfg, spec, params, games: int, gen):
    """One rollout of variant ``kind``; its probe (a scalar tensor)."""
    from ..agents.dqn import q_values
    from ..engine import deal, observe, step
    from ..nets import draw_mlp_noise
    from ..utils.ops import onehot_select, uniform_index

    dev = gen.device
    state = deal(cfg, int(torch.randint(0, 2**62, (1,), generator=gen, device=dev)), games, device=dev)
    probes = torch.zeros((), device=dev)
    for _ in range(cfg.max_turns):
        obs, masks = observe(cfg, state)
        probe = 0.0
        if kind == "no_act":
            hs = state.hands_sorted
            r = uniform_index(torch.rand(hs.shape[:2], generator=gen, device=dev), (hs >= 0).sum(dim=-1))
            actions = onehot_select(hs, r)
            probe = obs.sum()
        else:
            noise = None if kind == "mean_net" else draw_mlp_noise(spec, gen)
            q = q_values(dqn_cfg, spec, params, torch.zeros_like(obs) if kind == "no_obs_net" else obs, noise)
            actions = torch.argmax(torch.where(masks, q, NEG_INF), dim=-1)
            if kind == "no_obs_net":
                probe = obs.sum()     # the observation stays live for the probe
        state, rewards = step(cfg, state, actions.to(torch.int32))
        probes = probes + rewards.sum() + probe
    return probes


def timeit(one, chain: int, iters: int, dev) -> float:
    """ms a call: ``chain`` calls a timed chain, the median of ``iters`` after one untimed chain."""
    from .chain_timing import timed

    def chained():
        acc = torch.zeros((), device=dev)
        for _ in range(chain):
            acc = acc + one()
        return acc

    return timed(chained, dev, iters, warmup=1) / chain * 1e3


def main(argv=None):
    from ..engine import EnvConfig
    from ..utils.device import resolve_device
    from .chain_timing import flagship_cycle, run_cycles

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
    for kind in KINDS:
        out[f"rollout[{kind}]"] = ms = timeit(
            lambda: rollout_one(kind, cfg, dqn_cfg, spec, params, args.games, gen), args.chain, args.iters, dev)
        print(f"rollout[{kind:10s}]: {ms:7.2f} ms/cycle", flush=True)

    # Full cycles with varying learn_iters to price the Bellman phase.
    for iters in (0, 1, 8):
        if iters == 0:
            continue        # JAX's learn-free row is skipped (micro_cycle4.py:131-140)
        cycle, _, _, state = flagship_cycle(cfg, args.games, dev, iters)

        def one():
            nonlocal state
            state, (m,) = run_cycles(cycle, state, gen, 1)
            return m["loss"]

        out[f"full cycle [learn_iters={iters}]"] = ms = timeit(one, args.chain, args.iters, dev)
        print(f"full cycle [learn_iters={iters}]: {ms:7.2f} ms/cycle", flush=True)
    return out


if __name__ == "__main__":
    main()
