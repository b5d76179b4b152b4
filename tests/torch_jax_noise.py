"""JAX's device-block and arena randomness rebuilt as the port's noise tensors
(a helper of the port's parity tests, not a test module).

The JAX block draws everything from per-seat keys: ``split(k_dec, (G, P))``
each turn.  A search seat's decision splits its key round by round; a
learner seat takes ``fold_in(key, 1..3)``.  These functions replay those
draws with ``jax.random`` and hand them over as ``DecisionNoise`` and
``LearnerNoise`` tensors, jitted once per shape; :func:`arena_noise` replays
a ``play_match`` (one key a seat and turn) as an ``ArenaNoise``.
"""

import functools

import jax
import numpy as np
import torch

from rl6nimmt_tpu.nets import draw_mlp_noise as jdraw_mlp_noise
from rl6nimmt_torch.agents.device_search import DecisionNoise, RoundNoise
from rl6nimmt_torch.runtime.device_tournament import LearnerNoise

C, H = 104, 10


@functools.lru_cache(maxsize=None)
def _learner_draws_fn(noisy_specs):
    """JAX's learner draws from seat keys, jitted once per set of noisy specs."""
    def one(key):
        k1, k2, k3 = (jax.random.fold_in(key, i) for i in (1, 2, 3))
        return {"sample_hand": jax.random.gumbel(k1, (H,)), "sample_card": jax.random.gumbel(k1, (C,)),
                "explore": jax.random.uniform(k3),
                "explore_pick": jax.random.gumbel(jax.random.fold_in(k3, 1), (H,)),
                "q": [jdraw_mlp_noise(spec, k2) for spec in noisy_specs]}
    return jax.jit(jax.vmap(one))


def learner_noise(keys, G, P, slots_j, slots_t):
    """The learner draws of JAX's seat keys ``[G*P]`` as the port's LearnerNoise:
    ``fold_in(key, 1)`` the categorical samples' Gumbel noise, ``fold_in(key,
    2)`` the noisy nets' noise, ``fold_in(key, 3)`` epsilon-greedy's draws."""
    noisy = [(sj, st) for sj, st in zip(slots_j, slots_t) if sj.family == "dqn" and sj.spec.noisy]
    out = _learner_draws_fn(tuple(sj.spec for sj, _ in noisy))(keys)
    shape = lambda x: torch.from_numpy(np.array(x)).reshape((G, P) + np.shape(x)[1:])
    q = {st: [{k: shape(v) for k, v in layer.items()} for layer in out["q"][i]] for i, (_, st) in enumerate(noisy)}
    return LearnerNoise(**{k: shape(out[k]) for k in ("sample_hand", "sample_card", "explore", "explore_pick")},
                            q=q)


@functools.lru_cache(maxsize=None)
def _round_fn(K, P):
    """One round of JAX's decision noise for a batch of seat keys, jitted:
    ``key, k_first, k_deal, k_play = split(key, 4)``; the root samples'
    ``gumbel(k_first, (K, H))``, one ``uniform(split(k_deal, K)[k], (C,))``
    per determinization and per playout the turn chain of ``split(k_play,
    K)[k]`` (``key, sub = split(key)``, ``gumbel(sub, (P, C))``) over all H
    turns -- a decision at depth n uses its first n."""
    def one(key):
        key, k_first, k_deal, k_play = jax.random.split(key, 4)
        deal = jax.vmap(lambda k: jax.random.uniform(k, (C,)))(jax.random.split(k_deal, K))

        def chain(pk):
            def turn(pk, _):
                pk, sub = jax.random.split(pk)
                return pk, jax.random.gumbel(sub, (P, C))
            return jax.lax.scan(turn, pk, None, length=H)[1]

        play = jax.vmap(chain)(jax.random.split(k_play, K))                      # [K, H, P, C]
        return jax.random.key_data(key), jax.random.gumbel(k_first, (K, H)), deal, play
    return jax.jit(jax.vmap(one))


_random_fn = jax.jit(jax.vmap(lambda k: jax.random.gumbel(jax.random.fold_in(k, 0), (H,))))


def search_noise(keys, n_rounds, K, n, P):
    """JAX's kind-traced decision noise from the seat keys ``[N]``, round by
    round (:func:`_round_fn`), as a DecisionNoise; a seat's key moves on only
    in its own ``n_rounds``, and a random seat's pick is ``gumbel(fold_in(key,
    0), (H,))`` from the key after them."""
    N = keys.shape[0]
    cur = np.array(jax.random.key_data(keys))
    rounds = []
    for r in range(max(n_rounds, default=0)):
        nxt, first, deal, play = (np.array(x) for x in _round_fn(K, P)(jax.random.wrap_key_data(cur)))
        uniform = play[:, :, :n].reshape(N * K, n, P, C).transpose(1, 0, 2, 3)
        cur = np.where(np.asarray([r < m for m in n_rounds])[:, None], nxt, cur)
        rounds.append(RoundNoise(deal=torch.from_numpy(deal), first=torch.from_numpy(first),
                                 uniform=torch.from_numpy(np.ascontiguousarray(uniform))))
    random = torch.from_numpy(np.array(_random_fn(jax.random.wrap_key_data(cur))))
    return DecisionNoise(rounds=rounds, random=random)


def arena_noise(jpolicies, num_games, seed):
    """JAX's ``play_match(..., seed)`` randomness as the port's ArenaNoise: the
    dealt start (``key, deal_key = split(key)``, one ``deal`` a game from
    ``split(deal_key, G)``), then per turn ``key, *seat_keys = split(key, P +
    1)`` and per seat its draws -- a random seat's ``uniform(key, (G,))``, a
    policy seat's ``gumbel(key, (G, H))`` (``jax.random.categorical``), a DQN
    seat's ``noise_key, eps_key, rand_key = split(key, 3)``: the noisy net's
    ``draw_mlp_noise(spec, noise_key)``, shared by the G games, or
    epsilon-greedy's ``uniform(eps_key, (G,))`` and ``uniform(rand_key, (G,))``."""
    from rl6nimmt_tpu.engine.env import deal as jdeal
    from rl6nimmt_tpu.engine.state import EnvConfig as JEnvConfig
    from rl6nimmt_torch.engine import EnvState
    from rl6nimmt_torch.runtime.arena import ArenaNoise, SeatDraws

    P, G = len(jpolicies), num_games
    cfg = JEnvConfig(num_players=P)
    t = lambda x: torch.from_numpy(np.array(x))
    key = jax.random.key(seed)
    key, deal_key = jax.random.split(key)
    js = jax.vmap(lambda k: jdeal(cfg, k))(jax.random.split(deal_key, G))
    state = EnvState(*(t(getattr(js, f)) for f in ("board", "row_len", "hands", "hands_sorted", "scores", "turn")))
    turns = []
    for _ in range(cfg.max_turns):
        key, *seat_keys = jax.random.split(key, P + 1)
        draws = []
        for pol, k in zip(jpolicies, seat_keys):
            if pol.kind == "random":
                draws.append(SeatDraws(u=t(jax.random.uniform(k, (G,)))))
            elif pol.kind == "policy":
                draws.append(SeatDraws(gumbel=t(jax.random.gumbel(k, (G, cfg.hand_size)))))
            else:
                noise_key, eps_key, rand_key = jax.random.split(k, 3)
                if pol.dqn_cfg.noisy:
                    draws.append(SeatDraws(q=[{n: t(v) for n, v in layer.items()}
                                              for layer in jdraw_mlp_noise(pol.spec, noise_key)]))
                else:
                    draws.append(SeatDraws(explore=t(jax.random.uniform(eps_key, (G,))),
                                           pick=t(jax.random.uniform(rand_key, (G,)))))
        turns.append(draws)
    return ArenaNoise(deal_seed=0, turns=turns, state=state)
