"""Validate and time the act-rollout kernel (K4) against the engine path's greedy replay.

    python -m rl6nimmt_torch.experiments.act_rollout_probe [--chain 256] [--iters 5] [--games 4096]
        [--device cuda]

Port of ``experiments/act_rollout_probe.py`` on the flagship net (P=4,
Noisy-D3QN-PER-10step, hidden 64, params from seed 1):

1. draws T turns of factorized noise from a generator seeded 42 and forms
   each turn's effective weights, then plays G games in K4 from seed 7;
2. structural checks (:func:`structural_checks`): every hand holds ``H - t``
   cards at turn t, every action is in its seat's hand, the terminal hands
   are empty, no reward is positive;
3. replays the same deals (K2 on seed 7) on the engine path (K1 every turn,
   ``q_values`` on the same weights, ``ops/act_rollout_check.py``
   ``greedy_replay``) and reports the action and score agreement, the mean
   scores and the first divergence;
4. times chains of ``--chain`` K4 generations (seed ``7 + i * (G // 1024)``
   for generation i), each chain read through a checksum of its rewards,
   actions and first observations: the median of ``--iters`` chains after one
   untimed, in ms a generation and M env-steps/s.

The JAX script ran at module level with no flags; ``--chain``, ``--iters``
and ``--games`` only shorten the run.  K4 runs once for the checks (its
replay: K2 once, K1 ten times) and ``(1 + iters) * chain`` times for the
timing.  Returns the figures as a dict.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

G = 4096
CHAIN = 256
ITERS = 5


def structural_checks(obs, actions, rewards, hand_size: int) -> list:
    """The failures of the structural checks on one K4 trajectory (numpy:
    ``obs [T+1, G, P, S]``, ``actions`` and ``rewards [T, G, P]``); empty if
    every check holds."""
    T, H = actions.shape[0], hand_size
    fails = []
    for t in range(T):
        hand = obs[t, :, :, :H]
        if not np.all((hand >= 0).sum(-1) == H - t):
            fails.append(f"FAIL: hand count at t={t}")
        inhand = (hand == actions[t][:, :, None]).any(-1)
        if not np.all(inhand):
            fails.append(f"FAIL: illegal action at t={t} ({(~inhand).sum()} seats)")
    if not np.all(obs[T, :, :, :H] == -1):
        fails.append("FAIL: terminal hands not empty")
    if not np.all(rewards <= 0):
        fails.append("FAIL: positive rewards")
    return fails


def main(argv=None):
    from ..agents.dqn import DQNConfig, q_network_spec
    from ..engine import EnvConfig
    from ..nets import draw_mlp_noise, mlp_init
    from ..ops.act_rollout_check import greedy_replay, turn_effective_weights
    from ..ops.act_rollout_kernel import make_act_rollout_kernel
    from ..utils.device import resolve_device, synchronize
    from .chain_timing import FLAGSHIP, timed
    from .kernel_times import smi_line

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chain", type=int, default=CHAIN, help="K4 generations a timed chain")
    parser.add_argument("--iters", type=int, default=ITERS, help="timed chains")
    parser.add_argument("--games", type=int, default=G)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    games = args.games

    cfg = EnvConfig(num_players=4)
    dqn_cfg = DQNConfig(**FLAGSHIP)
    spec = q_network_spec(dqn_cfg, cfg.state_length, cfg.num_actions)
    params = mlp_init(torch.Generator().manual_seed(1), spec, dev)
    T, H = cfg.max_turns, cfg.hand_size
    turn_noise = [{k: v.to(dev) for k, v in layer.items()}
                  for layer in draw_mlp_noise(spec, torch.Generator().manual_seed(42), batch=(T,))]
    eff = turn_effective_weights(spec, params, turn_noise)
    w1, b1 = eff["trunk"][0]["w"].contiguous(), eff["trunk"][0]["b"].contiguous()
    wa, ba = eff["heads"][1]["w"].contiguous(), eff["heads"][1]["b"].contiguous()
    print("weight shapes:", tuple(w1.shape), tuple(b1.shape), tuple(wa.shape), tuple(ba.shape))

    # ---- K4's games and their replay on the engine path (same deals) -------
    (obs, actions, rewards), (xa, xscores) = greedy_replay(cfg, dqn_cfg, spec, params, games, 7, turn_noise)
    obs, actions, rewards = (x.cpu().numpy() for x in (obs, actions, rewards))
    xa, xscores = xa.cpu().numpy(), xscores.cpu().numpy()
    print("shapes:", obs.shape, actions.shape, rewards.shape)
    fails = structural_checks(obs, actions, rewards, H)
    for f in fails:
        print(f)
    scores = rewards.sum(0)
    print(f"structural checks: {'FAILED' if fails else 'OK'}; "
          f"mean score {scores.mean():.3f}  (uniform-random play is ~ -10.5/4p)")
    agree = float((xa == actions).mean())
    score_agree = float((xscores == scores).mean())
    print("deal parity (obs[0] equal): True")     # greedy_replay raises otherwise
    print(f"action agreement vs XLA replay: {agree:.6f}")
    print(f"score agreement: {score_agree:.6f}  mean xla {xscores.mean():.4f} vs kernel {scores.mean():.4f}")
    div = np.argwhere(xa != actions)
    first = None
    if len(div):
        t0, g0, p0 = (int(x) for x in div[0])
        first = {"t": t0, "g": g0, "p": p0, "xla": int(xa[t0, g0, p0]), "kernel": int(actions[t0, g0, p0])}
        print(f"first divergence t={t0} g={g0} p={p0}: xla={first['xla']} kernel={first['kernel']}")

    # ---- timing -------------------------------------------------------------
    play = make_act_rollout_kernel(cfg, games, hidden=spec.hidden_sizes[0])

    def kern_many():
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(args.chain):
            o, a, r = play(7 + i * (games // 1024), w1, b1, wa, ba)
            acc = acc + r.sum() + a.sum() + o[0, :, 0, 0].sum()
        return acc

    ms = timed(kern_many, dev, args.iters, warmup=1) / args.chain * 1e3
    synchronize(dev)
    rate = games * T / ms * 1000 / 1e6
    print(f"kernel rollout: {ms:6.3f} ms/generation ({rate:.1f}M env-steps/s)")
    card = smi_line() if dev.type == "cuda" else "cpu"
    print(f"card: {card}")
    return {"games": games, "structural_fails": fails, "mean_score": float(scores.mean()),
            "action_agreement": agree, "score_agreement": score_agree, "mean_score_replay": float(xscores.mean()),
            "first_divergence": first, "ms_per_generation": ms, "m_env_steps_per_s": rate, "chain": args.chain,
            "iters": args.iters, "card": card}


if __name__ == "__main__":
    main()
