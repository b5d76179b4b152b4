"""Vectorized self-play runtime (port of ``runtime/vector.py``).

* :func:`make_random_rollout` / :func:`make_random_rollout_generations` --
  uniform-legal random self-play with the observation checksum kept live.
  ``fused=True`` plays each generation in one K3 launch; otherwise the engine
  path deals with K2 and resolves every turn with K1.  Both draw from the
  same Philox streams, so for one seed they return the same totals and
  checksums.
* :func:`make_dqn_selfplay_step` -- the flagship Noisy-D3QN-PER-n-step
  cycle: greedy noisy acting (or eps-greedy for non-noisy configs), the
  lagged n-step harvest, a PER (or ring) insert, and ``learn_iters``
  double/dueling Bellman updates.  ``kernel_act_rollout=True`` plays the
  games in K4; ``kernel_insert=True`` plays the games AND writes the
  transitions into the replay planes in K5.

PyTorch runs eagerly: the make_* functions return plain Python closures.  The cycle
takes its randomness either from a ``torch.Generator`` or injected as a
:class:`CycleRandomness`, which is how the tests replay the JAX key schedule.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import torch
from torch.profiler import record_function

from ..agents.dqn import Adam, DQNConfig, learn_noise, make_learn_step, q_network_spec, q_values
from ..buffers.per import per_add_batch, per_mark_batch, per_sample, per_update
from ..buffers.ring import ring_add_batch, ring_sample
from ..engine.env import deal, init_from_deck, observe, step
from ..engine.state import EnvConfig
from ..nets import draw_mlp_noise, noisy_effective_params
from ..ops.act_rollout_check import turn_slice
from ..ops.act_rollout_kernel import TILE, make_act_insert_kernel, make_act_rollout_kernel
from ..ops.game_kernel import play_random_games, random_pick_words, random_picks
from ..utils.device import resolve_device
from ..utils.ops import onehot_select, uniform_index

NEG_INF = -1e9


# ----------------------------------------------------------- random rollouts


def make_random_rollout(cfg: EnvConfig, num_games: int, device="cuda"):
    """``seed -> (final_state, total_rewards int32[G, P], obs_checksum f64[])``.

    Plays G uniform-legal random games on the engine path (K2 deal, K1
    resolution).  Seat ``p``'s pick at turn ``t`` is hand slot ``(word *
    count) >> 32`` with the ``STREAM_PLAY`` Philox word of K3.  The checksum
    (every observation entry of every turn) keeps the observations live and is
    summed in float64 so it stays exact at any G.
    """
    dev = resolve_device(device)

    def rollout(seed: int):
        state = deal(cfg, seed, num_games, device=dev)
        words = random_pick_words(cfg, seed, num_games, dev)
        total = torch.zeros((num_games, cfg.num_players), dtype=torch.int32, device=dev)
        checksum = torch.zeros((), dtype=torch.float64, device=dev)
        for t in range(cfg.max_turns):
            obs, _ = observe(cfg, state)
            checksum = checksum + obs.sum(dtype=torch.float64)
            state, rewards = step(cfg, state, random_picks(state.hands_sorted, words[t]))
            total = total + rewards
        return state, total, checksum

    return rollout


def make_random_rollout_generations(cfg: EnvConfig, num_games: int, generations: int,
                                    fused: bool = False, device="cuda"):
    """``seed -> (total int32[G, P], checksum f64[])`` over ``generations``
    back-to-back generations; generation ``g`` plays from seed ``seed + g``.

    ``fused=True`` runs each generation as one K3 launch; otherwise the engine
    path of :func:`make_random_rollout`.
    """
    dev = resolve_device(device)
    single = None if fused else make_random_rollout(cfg, num_games, dev)

    def many(seed: int):
        total = torch.zeros((num_games, cfg.num_players), dtype=torch.int32, device=dev)
        checksum = torch.zeros((), dtype=torch.float64, device=dev)
        for g in range(generations):
            if fused:
                rewards, cs = play_random_games(cfg, seed + g, num_games, device=dev)
                cs = cs.sum(dtype=torch.float64)
            else:
                _, rewards, cs = single(seed + g)
            total = total + rewards
            checksum = checksum + cs
        return total, checksum

    return many


# ------------------------------------------------------------ DQN self-play


def lag_rewards(rewards: torch.Tensor) -> torch.Tensor:
    """Shift rewards one turn later along the leading time axis (r'_0 = 0)."""
    return torch.cat([torch.zeros_like(rewards[:1]), rewards[:-1]], dim=0)


def dqn_replay_example(cfg: EnvConfig, compact: bool = True) -> dict:
    """Example transition; ``compact`` stores states/action/done as int8
    (every observation entry is a small integer, so the round trip is exact)."""
    sdt = torch.int8 if compact else torch.float32
    return {
        "state": torch.zeros(cfg.state_length, dtype=sdt),
        "action": torch.zeros((), dtype=torch.int8 if compact else torch.int32),
        "reward": torch.zeros((), dtype=torch.float32),
        "next_state": torch.zeros(cfg.state_length, dtype=sdt),
        "done": torch.zeros((), dtype=torch.int8 if compact else torch.float32),
    }


def to_transitions(cfg: EnvConfig, gamma: float, n_steps: int, reward_lag: bool,
                   obs, actions, rewards, next_obs) -> dict:
    """n-step transitions from ``[T, G, P, ...]`` trajectories, flattened in
    (t, g, p) order (reference dqn.py:264-301: truncated discounted sums,
    terminal bootstrap, the flushed tail marked done)."""
    T, n = cfg.max_turns, n_steps
    if reward_lag:
        rewards = lag_rewards(rewards)
    padded = torch.cat([rewards, rewards.new_zeros((n - 1,) + rewards.shape[1:])]) if n > 1 else rewards
    disc = torch.tensor([gamma ** i for i in range(n)], dtype=rewards.dtype, device=rewards.device)
    R = sum(disc[i] * padded[i: i + T] for i in range(n))
    if n >= T:
        next_states = next_obs[T - 1][None].expand_as(next_obs)
    elif n > 1:
        idx_next = torch.clamp(torch.arange(T, device=obs.device) + n, max=T)
        next_states = next_obs[idx_next - 1]
    else:
        next_states = next_obs
    tail_start = (T - n + 1) if n > 1 else (T - 1)
    done = (torch.arange(T, device=obs.device) >= tail_start)[:, None, None].expand(rewards.shape)
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[3:]))
    return {
        "state": flat(obs),
        "action": flat(actions),
        "reward": flat(R.to(torch.float32)),
        "next_state": flat(next_states),
        "done": flat(done.to(torch.float32)),
    }


@dataclass
class CycleRandomness:
    """Everything random one cycle consumes.

    * ``decks`` ``int[G, C]`` (engine path; dealt with ``init_from_deck``) or
      ``deal_seed`` (engine path through K2, or the K4 and K5 paths);
    * ``turn_noise``: per-layer ``{"eps_in" [T,in,1], "eps_out" [T,1,out]}``
      (noisy configs);
    * ``learn_noise``: one :func:`agents.dqn.learn_noise` pair per update
      (noisy configs);
    * ``per_uniforms`` ``f32[learn_iters, minibatch]`` in [0, 1) (PER, or the
      ring's uniform sample);
    * ``explore_u`` / ``pick_u`` ``f32[T, G, P]``: the eps-greedy branch's
      explore test and uniform-legal pick (non-noisy configs).
    """

    per_uniforms: torch.Tensor
    decks: Optional[torch.Tensor] = None
    deal_seed: Optional[int] = None
    turn_noise: Optional[list] = None
    learn_noise: Optional[List] = None
    explore_u: Optional[torch.Tensor] = None
    pick_u: Optional[torch.Tensor] = None


def draw_cycle_randomness(cfg: EnvConfig, dqn_cfg: DQNConfig, num_games: int,
                          learn_iters: int, generator: torch.Generator) -> CycleRandomness:
    """Draw one cycle's :class:`CycleRandomness` on the generator's device."""
    spec = q_network_spec(dqn_cfg, cfg.state_length, cfg.num_actions)
    dev = generator.device
    T, P = cfg.max_turns, cfg.num_players
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=dev).item())
    rnd = CycleRandomness(
        per_uniforms=torch.rand((learn_iters, dqn_cfg.minibatch), generator=generator, device=dev),
        deal_seed=seed,
    )
    if dqn_cfg.noisy:
        rnd.turn_noise = draw_mlp_noise(spec, generator, batch=(T,))
        rnd.learn_noise = [learn_noise(dqn_cfg, spec, generator) for _ in range(learn_iters)]
    else:
        rnd.explore_u = torch.rand((T, num_games, P), generator=generator, device=dev)
        rnd.pick_u = torch.rand((T, num_games, P), generator=generator, device=dev)
    return rnd


def make_dqn_selfplay_step(
    cfg: EnvConfig,
    dqn_cfg: DQNConfig,
    optimizer: Adam,
    num_games: int,
    gamma: float = 0.99,
    learn_iters: int = 10,
    reward_lag: bool = True,
    axis_name: Optional[str] = None,
    per_aligned_capacity: Optional[int] = None,
    kernel_act_rollout: bool = False,
    feature_major: bool = False,
    kernel_insert: bool = False,
    device="cuda",
):
    """Self-play cycle: rollout + replay insert + ``learn_iters`` Bellman updates.

    ``cycle(params, target_params, opt_state, buf, rng, eps, step0=0) ->
    (params, target_params, opt_state, buf, metrics)`` where ``rng`` is a
    ``torch.Generator`` or a :class:`CycleRandomness`.  ``buf`` is updated in
    place; which buffer it must be depends on the options:

    * ``per_init`` (PER configs) or ``ring_init``: row-major, slots in
      (t, g, p) order;
    * ``per_init_kd(cap, S_PAD, SCAL_ROWS)`` with ``kernel_insert=True``: K5
      plays the games from ``deal_seed`` and writes the finished transitions
      into the planes itself (noisy PER configs with one hidden layer,
      ``n_steps >= max_turns``, ``num_games`` a multiple of 128, ``cap`` a
      multiple of ``T*P*128`` and at least ``T*P*num_games``); slot order
      (128-game tile, t, p, g) -- the same multiset of transitions per cycle
      as row-major, in another slot order.

    ``kernel_act_rollout=True`` (noisy configs with one hidden layer) plays
    the games in K4 from ``deal_seed``; the engine path otherwise.
    ``feature_major`` and ``per_aligned_capacity`` (the JAX package's TPU
    replay layouts) and ``axis_name`` are not ported.
    """
    T, P, G = cfg.max_turns, cfg.num_players, num_games
    n = dqn_cfg.n_steps
    if axis_name is not None:
        raise NotImplementedError("axis_name: ROADMAP queue 1 item 11 (data parallel)")
    if feature_major or per_aligned_capacity is not None:
        raise NotImplementedError("feature_major / per_aligned_capacity: TPU replay layouts "
                                  "with no GPU workload, see ROADMAP queue 1 item 1")
    if kernel_insert:
        if not dqn_cfg.per:
            raise ValueError("kernel_insert requires a PER config (per_init_kd storage)")
        if not dqn_cfg.noisy:
            raise ValueError("kernel_insert requires a noisy config (greedy act)")
        if len(dqn_cfg.hidden_sizes) != 1:
            raise ValueError("kernel_insert supports one hidden layer")
        if n < T:
            raise ValueError("kernel_insert requires n_steps >= max_turns")
        if kernel_act_rollout:
            raise ValueError("kernel_insert subsumes kernel_act_rollout; pass kernel_insert alone")
        if G % TILE != 0:
            raise ValueError(f"kernel_insert requires num_games % {TILE} == 0 (got {G})")
    if kernel_act_rollout:
        if not dqn_cfg.noisy:
            raise ValueError("kernel_act_rollout requires a noisy config (greedy act)")
        if len(dqn_cfg.hidden_sizes) != 1:
            raise ValueError("kernel_act_rollout supports one hidden layer")

    dev = resolve_device(device)
    spec = q_network_spec(dqn_cfg, cfg.state_length, cfg.num_actions)
    eff_spec = dataclasses.replace(spec, noisy=False)
    learn_step = make_learn_step(dqn_cfg, spec, optimizer, gamma)
    adv_head = 1 if dqn_cfg.dueling else 0
    play_kernel = make_act_rollout_kernel(cfg, G, hidden=dqn_cfg.hidden_sizes[0]) if kernel_act_rollout else None

    def initial_state(rnd: CycleRandomness):
        if rnd.decks is not None:
            return init_from_deck(cfg, rnd.decks.to(dev))
        return deal(cfg, rnd.deal_seed, G, device=dev)

    def rollout(params, rnd: CycleRandomness, eps, store_dtype):
        state = initial_state(rnd)
        obs_l, act_l, rew_l = [], [], []
        if dqn_cfg.noisy:
            eff = noisy_effective_params(spec, params, rnd.turn_noise)
        for t in range(T):
            obs, masks = observe(cfg, state)
            if dqn_cfg.noisy:
                # Noisy nets act greedily on this turn's effective weights.
                q = q_values(dqn_cfg, eff_spec, turn_slice(eff, t), obs)
                actions = torch.argmax(torch.where(masks, q, NEG_INF), dim=-1)
            else:
                q = q_values(dqn_cfg, spec, params, obs)
                greedy = torch.argmax(torch.where(masks, q, NEG_INF), dim=-1)
                hs = state.hands_sorted
                r = uniform_index(rnd.pick_u[t], (hs >= 0).sum(dim=-1))
                explore = rnd.explore_u[t] < eps
                actions = torch.where(explore, onehot_select(hs, r).long(), greedy)
            actions = actions.to(torch.int32)
            state, rewards = step(cfg, state, actions)
            obs_l.append(obs.to(store_dtype))
            act_l.append(actions)
            rew_l.append(rewards.to(torch.float32))
        obs = torch.stack(obs_l)
        final_obs, _ = observe(cfg, state)
        next_obs = torch.cat([obs[1:], final_obs.to(store_dtype)[None]], dim=0)
        return obs, torch.stack(act_l), torch.stack(rew_l), next_obs, -state.scores

    def act_weights(params, rnd: CycleRandomness):
        """K4/K5's arguments: this cycle's per-turn effective weights of the
        hidden layer and the advantage head."""
        eff = noisy_effective_params(spec, params, rnd.turn_noise)
        return (eff["trunk"][0]["w"].contiguous(), eff["trunk"][0]["b"].contiguous(),
                eff["heads"][adv_head]["w"].contiguous(), eff["heads"][adv_head]["b"].contiguous())

    def rollout_kernel(params, rnd: CycleRandomness, store_dtype):
        obs_all, actions, rewards_i = play_kernel(rnd.deal_seed, *act_weights(params, rnd))
        obs = obs_all[:T].to(store_dtype)
        next_obs = obs_all[1:].to(store_dtype)
        return obs, actions, rewards_i.to(torch.float32), next_obs, rewards_i.sum(dim=0)

    def learn_once(carry, t: int, u, noise):
        params, target_params, opt_state, buf = carry
        if dqn_cfg.per:
            buf, idx, weights, batch = per_sample(buf, u, dqn_cfg.minibatch,
                                                  slot_axis=-1 if kernel_insert else 0)
        else:
            idx, batch = ring_sample(buf, u)
            weights = torch.ones(dqn_cfg.minibatch, dtype=torch.float32, device=dev)
        if kernel_insert:
            # kd planes: [S_PAD, n] int8 states, f32 rows reward/action/done.
            S = cfg.state_length
            batch = {
                "state": batch["state"][:S].to(torch.float32).T,
                "action": batch["scalars"][1].to(torch.int64),
                "reward": batch["scalars"][0],
                "next_state": batch["next_state"][:S].to(torch.float32).T,
                "done": batch["scalars"][2],
            }
        else:
            batch = {
                "state": batch["state"].to(torch.float32),
                "action": batch["action"].to(torch.int64),
                "reward": batch["reward"].to(torch.float32),
                "next_state": batch["next_state"].to(torch.float32),
                "done": batch["done"].to(torch.float32),
            }
        batch["weights"] = weights
        do_soft = (t % dqn_cfg.retrain_interval) == 0
        params, target_params, opt_state, loss, abs_err, _ = learn_step(
            params, target_params, opt_state, batch, do_soft,
            noise=noise if dqn_cfg.noisy else None,
        )
        if dqn_cfg.per:
            buf = per_update(buf, idx, abs_err)
        return (params, target_params, opt_state, buf), loss

    def play_and_insert(params, rnd: CycleRandomness, buf, eps):
        """Rollout and replay insert of one cycle; returns ``(buf, scores)``."""
        if kernel_insert:
            with record_function("cycle.rollout"):
                st = buf.storage
                insert = make_act_insert_kernel(cfg, G, dqn_cfg.hidden_sizes[0], buf.capacity,
                                                gamma, n, reward_lag)
                planes = insert(
                    rnd.deal_seed, buf.ptr, *act_weights(params, rnd),
                    st["state"], st["next_state"], st["scalars"])
            with record_function("cycle.insert"):
                buf = per_mark_batch(buf, dict(zip(("state", "next_state", "scalars"), planes[:3])),
                                     T * G * P)
            return buf, planes[3].reshape(T, P, G).to(torch.float32).sum(dim=0)
        store_dtype = buf.storage["state"].dtype
        with record_function("cycle.rollout"):
            if kernel_act_rollout:
                obs, actions, rewards, next_obs, scores = rollout_kernel(params, rnd, store_dtype)
            else:
                obs, actions, rewards, next_obs, scores = rollout(params, rnd, eps, store_dtype)
        with record_function("cycle.insert"):
            transitions = to_transitions(cfg, gamma, n, reward_lag, obs, actions, rewards, next_obs)
            buf = per_add_batch(buf, transitions) if dqn_cfg.per else ring_add_batch(buf, transitions)
        return buf, scores

    def cycle(params, target_params, opt_state, buf, rng, eps, step0: int = 0):
        rnd = rng if isinstance(rng, CycleRandomness) else \
            draw_cycle_randomness(cfg, dqn_cfg, G, learn_iters, rng)
        # The three spans name the cycle's phases in a torch.profiler trace.
        buf, scores = play_and_insert(params, rnd, buf, eps)
        carry = (params, target_params, opt_state, buf)
        losses = []
        with record_function("cycle.learn"):
            for i in range(learn_iters):
                noise = rnd.learn_noise[i] if dqn_cfg.noisy else None
                carry, loss = learn_once(carry, step0 + i, rnd.per_uniforms[i], noise)
                losses.append(loss)
        params, target_params, opt_state, buf = carry
        metrics = {
            "loss": torch.stack(losses).mean(),
            "mean_score": scores.to(torch.float32).mean(),
        }
        return params, target_params, opt_state, buf, metrics

    return cycle
