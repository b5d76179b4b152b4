"""The arena scoring the evaluation twins share: a policy against three random
seats, and two policies head to head with the seats alternated.

Each match (``runtime/arena.py`` ``make_arena``) draws from an injected
``ArenaNoise`` when one is given, else from a ``torch.Generator`` seeded with
the integer the JAX script made its key from (``PARITY_TORCH.md`` section 19).
"""

from __future__ import annotations

import numpy as np
import torch


def noise_or_generator(noise, seed: int, dev):
    """The injected ArenaNoise, or a generator seeded with JAX's key integer."""
    return noise if noise is not None else torch.Generator(device=dev).manual_seed(seed)


def win_vs_random(scores) -> float:
    """Seat 0's win rate (a shared top score counts as a win, as JAX's)."""
    scores = np.asarray(scores)
    return float(np.sum(scores[:, 0] == scores.max(axis=1)) / scores.shape[0])


def alternating_record(s_a, s_b):
    """Side A's win rate (ties half), its binomial standard error and the games:
    A in seat 0 of ``s_a``, in seat 1 of ``s_b``."""
    s_a, s_b = np.asarray(s_a), np.asarray(s_b)
    wins = float(np.sum(s_a[:, 0] > s_a[:, 1]) + np.sum(s_b[:, 1] > s_b[:, 0]))
    ties = float(np.sum(s_a[:, 0] == s_a[:, 1]) + np.sum(s_b[:, 1] == s_b[:, 0]))
    n = s_a.shape[0] + s_b.shape[0]
    rate = (wins + 0.5 * ties) / n
    return rate, (rate * (1 - rate) / n) ** 0.5, n


def vs_random(policy, params, games: int, seed: int, dev, noise=None) -> float:
    """``policy`` with ``params`` in seat 0 of ``games`` four-seat games against
    three uniform-random seats; its win rate."""
    from ..engine import EnvConfig
    from ..runtime.arena import SeatPolicy, make_arena

    arena = make_arena(EnvConfig(num_players=4), (policy,) + (SeatPolicy("random"),) * 3, games, device=dev)
    scores = arena((params, None, None, None), (0.0,) * 4, noise_or_generator(noise, seed, dev))
    return win_vs_random(scores.cpu().numpy())


def head_to_head(policy_a, policy_b, params_a, params_b, games: int, seed: int, dev, noises=(None, None)):
    """Two-seat games of A against B, ``games`` with A in seat 0 (key ``seed``)
    and ``games`` with B there (key ``seed + 1``): :func:`alternating_record`."""
    from ..engine import EnvConfig
    from ..runtime.arena import make_arena

    cfg = EnvConfig(num_players=2)
    ab = make_arena(cfg, (policy_a, policy_b), games, device=dev)
    ba = make_arena(cfg, (policy_b, policy_a), games, device=dev)
    s_ab = ab((params_a, params_b), (0.0, 0.0), noise_or_generator(noises[0], seed, dev)).cpu().numpy()
    s_ba = ba((params_b, params_a), (0.0, 0.0), noise_or_generator(noises[1], seed + 1, dev)).cpu().numpy()
    return alternating_record(s_ab, s_ba)
