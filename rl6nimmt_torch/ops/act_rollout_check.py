"""K4 and K5 held against the engine path (port of ``ops/act_rollout_check.py``).

Protocol: K4 plays greedy games from its Philox deals; ``deal_games`` (K2)
reproduces those deals, which seed the engine; the engine path (``step``
through K1, torch ``q_values`` on the same per-turn effective weights, the
full dueling Q with the legal mask) replays the same turns.  The t=0
observations must agree exactly (asserted); the action and final-score
agreement fractions are returned (callers gate on >= 0.999; the budget
covers float rounding of near-ties between the two summation orders).
:func:`insert_planes_agreement` holds K5's replay planes against the n-step
harvests of K4's trajectory in both of its layouts; :func:`fm_agreement`
holds K4's feature-major emit against its row-major one.
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
    (_, actions, rewards), (replay_actions, replay_scores) = greedy_replay(
        cfg, dqn_cfg, spec, params, num_games, seed, turn_noise)
    action_agree = (replay_actions == actions).float().mean().item()
    score_agree = (replay_scores == rewards.sum(dim=0)).float().mean().item()
    return action_agree, score_agree


def greedy_replay(cfg: EnvConfig, dqn_cfg: DQNConfig, spec: MLPSpec, params,
                  num_games: int, seed: int, turn_noise):
    """K4's games from ``seed`` and their replay on the engine path:
    ``((obs, actions, rewards) of K4, (actions [T, G, P], scores [G, P]) of
    the replay)``.  Raises ``AssertionError`` unless the replay's deals (K2 on
    the same seed) equal K4's t=0 observations."""
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
    return (obs, actions, rewards), (torch.stack(replay_actions), -state.scores)


def fm_agreement(cfg: EnvConfig, num_games: int, hidden: int, seed: int, weights) -> None:
    """K4's feature-major outputs against its row-major outputs permuted, on
    one seed and one set of per-turn weights: equal bit for bit (the two
    entries play the same games through the same loop).  Raises
    ``AssertionError`` on a mismatch; runs on the device of ``weights``."""
    from .act_rollout_kernel import to_feature_major

    fm = make_act_rollout_kernel(cfg, num_games, hidden, feature_major=True)(seed, *weights)
    rm = to_feature_major(*make_act_rollout_kernel(cfg, num_games, hidden)(seed, *weights))
    for name, a, b in zip(("obs", "actions", "rewards"), fm, rm):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"K4 feature-major {name} differ from the row-major ones permuted "
                                 f"(G={num_games}, hidden {hidden})")


def insert_planes_agreement(cfg: EnvConfig, dqn_cfg: DQNConfig, spec: MLPSpec, params,
                            num_games: int, capacity: int, seed: int, ptr: int, turn_noise,
                            gamma: float = 0.99, sentinel: int = -7) -> float:
    """K5's replay planes against K4's trajectory on the same seed and weights.

    K5 writes into planes pre-filled with ``sentinel``.  Its ``rewards`` must
    equal K4's in both layouts; under the column map (:func:`insert_columns`)
    its states, next states, actions and done must equal, bit for bit, both
    the row-major harvest (:func:`..runtime.vector.to_transitions`) of K4's
    row-major trajectory and the feature-major harvest
    (:func:`..runtime.vector.to_transitions_fm`) of K4's feature-major one,
    and its n-step rewards must be within ``atol=1e-3`` of each (the
    recursion and the windowed sum round differently); pad rows must be zero
    and the unwritten columns must still hold the sentinel.  Raises ``AssertionError`` on any
    mismatch; returns the largest reward difference.  Runs on the device of
    ``params``.
    """
    from ..runtime.vector import to_transitions, to_transitions_fm
    from .act_rollout_kernel import S_PAD, SCAL_ROWS, insert_columns, make_act_insert_kernel

    G, T, P, S = num_games, cfg.max_turns, cfg.num_players, cfg.state_length
    eff = turn_effective_weights(spec, params, turn_noise)
    adv = 1 if dqn_cfg.dueling else 0
    args = tuple(x.contiguous() for x in (eff["trunk"][0]["w"], eff["trunk"][0]["b"],
                                          eff["heads"][adv]["w"], eff["heads"][adv]["b"]))
    dev = args[0].device
    insert = make_act_insert_kernel(cfg, G, spec.hidden_sizes[0], capacity, gamma, dqn_cfg.n_steps)
    planes = (torch.full((S_PAD, capacity), sentinel, dtype=torch.int8, device=dev),
              torch.full((S_PAD, capacity), sentinel, dtype=torch.int8, device=dev),
              torch.full((SCAL_ROWS, capacity), float(sentinel), dtype=torch.float32, device=dev))
    st, nx, sc, rew = insert(seed, ptr, *args, *planes)
    obs, actions, rewards = make_act_rollout_kernel(cfg, G, spec.hidden_sizes[0])(seed, *args)
    if not torch.equal(rew, rewards.permute(0, 2, 1).reshape(T * P, G)):
        raise AssertionError("K5 rewards differ from K4's on the same seed")

    obs_fm, act_fm, rew_fm = make_act_rollout_kernel(cfg, G, spec.hidden_sizes[0], feature_major=True)(seed, *args)
    if not torch.equal(rew, rew_fm):
        raise AssertionError("K5 rewards differ from K4's feature-major ones on the same seed")

    rm = to_transitions(cfg, gamma, dqn_cfg.n_steps, True,
                        obs[:T], actions, rewards.to(torch.float32), obs[1:])
    fm = to_transitions_fm(cfg, gamma, dqn_cfg.n_steps, True, obs_fm, act_fm, rew_fm)
    harvests = {"row-major": {k: column_order(v, T, G, P) for k, v in rm.items()},     # [..., T, P, G]
                "feature-major": {k: v.reshape(v.shape[:-1] + (T, P, G)) for k, v in fm.items()}}
    cols = insert_columns(cfg, G, capacity, ptr, dev)                 # [T, P, G]
    reward_err = 0.0
    for layout, want in harvests.items():
        checks = {"state": (st[:S, cols], want["state"]), "next_state": (nx[:S, cols], want["next_state"]),
                  "action": (sc[1, cols], want["action"].to(torch.float32)), "done": (sc[2, cols], want["done"])}
        for name, (got, ref) in checks.items():
            if not torch.equal(got, ref):
                raise AssertionError(f"K5 {name} plane differs from the {layout} n-step harvest of K4's games")
        err = float((sc[0, cols] - want["reward"]).abs().max())
        if not err <= 1e-3:
            raise AssertionError(f"K5 n-step rewards differ from the {layout} harvest by {err}")
        reward_err = max(reward_err, err)
    if not (torch.all(st[S:, cols] == 0) and torch.all(nx[S:, cols] == 0) and torch.all(sc[3:, cols] == 0)):
        raise AssertionError("K5 left a nonzero pad row")
    unwritten = torch.ones(capacity, dtype=torch.bool, device=dev)
    unwritten[cols.reshape(-1)] = False
    if not (torch.all(st[:, unwritten] == sentinel) and torch.all(nx[:, unwritten] == sentinel)
            and torch.all(sc[:, unwritten] == sentinel)):
        raise AssertionError("K5 wrote outside its columns")
    return reward_err


def column_order(x: torch.Tensor, T: int, G: int, P: int) -> torch.Tensor:
    """Row-major transitions ``[T*G*P, ...]`` in (t, g, p) order as
    ``[..., T, P, G]``, the layout of K5's planes indexed by
    :func:`insert_columns`."""
    x = x.reshape((T, G, P) + tuple(x.shape[1:]))
    return x.permute(tuple(range(3, x.dim())) + (0, 2, 1))


def insert_twin_agreement(cfg: EnvConfig, num_games: int, hidden: int, capacity: int, ptr: int,
                          seed: int, weights, gamma: float = 0.99, n_steps: int = 10,
                          sentinel: int = -7) -> Tuple[float, int, float]:
    """K5 against its plain twin on the same inputs (the card's check).

    Both write into planes pre-filled with ``sentinel``.  In the games whose
    actions agree (near-ties may flip, as for K4), every written column of
    every plane and the returned rewards must be equal bit for bit; pad rows
    must be zero and unwritten columns must keep the sentinel.  Returns
    ``(action agreement, agreeing games, largest difference in agreeing
    games)``; raises ``AssertionError`` on a mismatch.
    """
    from .act_rollout_kernel import (S_PAD, SCAL_ROWS, act_insert_plain, insert_columns,
                                     make_act_insert_kernel)

    G, T, P, S = num_games, cfg.max_turns, cfg.num_players, cfg.state_length
    dev = weights[0].device

    def planes():
        return (torch.full((S_PAD, capacity), sentinel, dtype=torch.int8, device=dev),
                torch.full((S_PAD, capacity), sentinel, dtype=torch.int8, device=dev),
                torch.full((SCAL_ROWS, capacity), float(sentinel), dtype=torch.float32, device=dev))

    kern = make_act_insert_kernel(cfg, G, hidden, capacity, gamma, n_steps)(seed, ptr, *weights, *planes())
    twin = act_insert_plain(cfg, seed, G, *weights, ptr, *planes(), gamma, n_steps)
    cols = insert_columns(cfg, G, capacity, ptr, dev)                     # [T, P, G]
    same_action = kern[2][1, cols] == twin[2][1, cols]
    agree = same_action.all(dim=(0, 1))                                   # [G]
    pairs = [(k[:, cols][..., agree], t[:, cols][..., agree]) for k, t in zip(kern[:3], twin[:3])]
    pairs.append((kern[3].reshape(T, P, G)[..., agree], twin[3].reshape(T, P, G)[..., agree]))
    for name, (a, b) in zip(("state", "next_state", "scalars", "rewards"), pairs):
        if not torch.equal(a, b):
            raise AssertionError(f"K5 {name} differs from its twin in games whose actions agree")
    written = torch.zeros(capacity, dtype=torch.bool, device=dev)
    written[cols.reshape(-1)] = True
    for name, out in (("kernel", kern), ("twin", twin)):
        st, nx, sc = out[:3]
        if not (torch.all(st[S:, written] == 0) and torch.all(nx[S:, written] == 0)
                and torch.all(sc[3:, written] == 0)):
            raise AssertionError(f"{name} left a nonzero pad row")
        if not (torch.all(st[:, ~written] == sentinel) and torch.all(nx[:, ~written] == sentinel)
                and torch.all(sc[:, ~written] == sentinel)):
            raise AssertionError(f"{name} wrote outside its columns")
    err = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0 for a, b in pairs)
    return same_action.float().mean().item(), int(agree.sum()), err
