"""K4's games replayed by the engine path (port of ``ops/act_rollout_check.py``).

Protocol: K4 plays greedy games from its Philox deals; ``deal_games`` (K2)
reproduces those deals, which seed the engine; the engine path (``step``
through K1, torch ``q_values`` on the same per-turn effective weights, the
full dueling Q with the legal mask) replays the same turns.  The t=0
observations must agree exactly (asserted); the action and final-score
agreement fractions are returned (callers gate on >= 0.999; the budget
covers float rounding of near-ties between the two summation orders).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..agents.dqn import DQNConfig, q_values
from ..engine.env import deal, observe, step
from ..engine.state import EnvConfig
from ..nets import MLPSpec, noisy_effective_params
from .act_rollout_kernel import NEG_INF, make_act_rollout_kernel


def turn_effective_weights(spec: MLPSpec, params, turn_noise) -> dict:
    """Stacked per-turn effective weights (``w [T, in, out]``, ``b [T, out]``)
    from per-turn noise (per-layer dicts with a leading turn axis)."""
    return noisy_effective_params(spec, params, turn_noise)


def turn_slice(eff: dict, t: int) -> dict:
    """Turn ``t``'s layers out of stacked effective weights."""
    return {part: [{k: v[t] for k, v in layer.items()} for layer in eff[part]]
            for part in ("trunk", "heads")}


def greedy_replay_agreement(cfg: EnvConfig, dqn_cfg: DQNConfig, spec: MLPSpec, params,
                            num_games: int, seed: int, turn_noise) -> Tuple[float, float]:
    """Play ``num_games`` with K4, replay them on the engine path, and return
    the (action agreement, score agreement) fractions.  Runs on the device of
    ``params`` (K4/K2/K1 on the card, the plain twins on the CPU)."""
    eff = turn_effective_weights(spec, params, turn_noise)
    adv = 1 if dqn_cfg.dueling else 0
    play = make_act_rollout_kernel(cfg, num_games, hidden=spec.hidden_sizes[0])
    obs, actions, rewards = play(seed, eff["trunk"][0]["w"], eff["trunk"][0]["b"],
                                 eff["heads"][adv]["w"], eff["heads"][adv]["b"])

    dev = eff["trunk"][0]["w"].device
    state = deal(cfg, seed, num_games, device=dev)
    o0, _ = observe(cfg, state)
    if not torch.equal(o0, obs[0].to(torch.float32)):
        raise AssertionError("K4 deals differ from deal_games on the same seed")

    eff_spec = dataclasses.replace(spec, noisy=False)
    replay_actions = []
    for t in range(cfg.max_turns):
        o, masks = observe(cfg, state)
        q = q_values(dqn_cfg, eff_spec, turn_slice(eff, t), o)
        acts = torch.argmax(torch.where(masks, q, NEG_INF), dim=-1).to(torch.int32)
        state, _ = step(cfg, state, acts)
        replay_actions.append(acts)
    replay_actions = torch.stack(replay_actions)
    action_agree = (replay_actions == actions).float().mean().item()
    score_agree = ((-state.scores) == rewards.sum(dim=0)).float().mean().item()
    return action_agree, score_agree
