"""Vectorized self-play runtime (port of ``runtime/vector.py``).

* :func:`make_random_rollout` / :func:`make_random_rollout_generations` --
  uniform-legal random self-play with the observation checksum kept live.
  ``fused=True`` plays each generation in one K3 launch; ``games_last=True``
  deals with K2 and keeps the board games-last through the generation,
  resolving every turn with the games-last K1; otherwise the engine path
  deals with K2 and resolves every turn with the row-major K1.  All three
  draw from the same Philox streams, so for one seed they return the same
  totals and checksums.
* :func:`make_dqn_selfplay_step` -- the flagship Noisy-D3QN-PER-n-step
  cycle: greedy noisy acting (or eps-greedy for non-noisy configs), the
  lagged n-step harvest, a PER (or ring) insert, and ``learn_iters``
  double/dueling Bellman updates.  ``kernel_act_rollout=True`` plays the
  games in K4; ``kernel_insert=True`` plays the games AND writes the
  transitions into the replay planes in K5; ``feature_major=True`` keeps the
  replay slots on the last axis (:func:`to_transitions_fm`), and
  ``per_aligned_capacity`` inserts into a block-aligned buffer.
* :func:`make_reinforce_rollout` / :func:`make_reinforce_train_step` -- the
  action-in-input REINFORCE learner trained from every seat of every game
  (the fused-gradient step by default).
* :func:`make_acer_rollout` / :func:`make_acer_selfplay_step` -- the ACER
  self-play cycle over the device sequence buffer.

PyTorch runs eagerly: the make_* functions return plain Python closures.  The cycle
takes its randomness either from a ``torch.Generator`` or injected as a
:class:`CycleRandomness` (:class:`RolloutRandomness` for REINFORCE,
:class:`AcerRandomness` for ACER), which is how the tests replay the JAX key
schedule.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import torch

from ..agents.dqn import (Adam, DQNConfig, grad_leaves, grads_of, learn_noise, make_learn_step, optimizer_apply,
                          q_network_spec, q_values)
from ..agents.reinforce import action_in_input_logits, log_probs_and_entropy
from ..buffers.per import per_add_batch, per_add_batch_aligned, per_mark_batch, per_sample, per_update
from ..buffers.ring import ring_add_batch, ring_sample
from ..buffers.sequence import seq_sample, seq_store_batch
from ..engine.env import card_points_formula, deal, init_from_deck, observe, shift_hands, step
from ..engine.state import EnvConfig
from ..nets import MLPSpec, draw_mlp_noise, noisy_effective_params
from ..ops.act_rollout_check import turn_slice
from ..ops.act_rollout_kernel import TILE, make_act_insert_kernel, make_act_rollout_kernel, to_feature_major
from ..ops.game_kernel import deal_games, play_random_games, random_pick_words, random_picks
from ..ops.step_kernel import resolve_turn_t
from ..utils.device import resolve_device
from ..utils.ops import onehot_select, pmean_fused, uniform_index
from ..utils.returns import discounted_returns
from ..utils.spans import span

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


def observation_sum_t(cfg: EnvConfig, board_t, row_len_t, hands_sorted) -> torch.Tensor:
    """Sum of every entry of every seat's observation (:func:`observe`'s
    layout), read from the games-last board ``board_t [R*T, G]``, ``row_len_t
    [R, G]``: the counterpart of the JAX ``observe_from``.  Every term is an
    integer, so the float64 sum is exact and equals ``observe(...)[0].sum()``."""
    R, T, P = cfg.num_rows, cfg.threshold, cfg.num_players
    f64 = torch.float64
    game = board_t.sum(dtype=f64) + P * board_t.shape[1]     # the board cells, the num_players entry
    if cfg.include_summaries:
        board = board_t.view(R, T, -1)
        slot = torch.arange(T, device=board_t.device)[:, None]
        lens = row_len_t[:, None, :]
        game = (game + row_len_t.sum(dtype=f64) + torch.where(slot == lens - 1, board, 0).sum(dtype=f64)
                + torch.where(slot < lens, card_points_formula(board), 0).sum(dtype=f64))
    return hands_sorted.sum(dtype=f64) + P * game


def _make_games_last_rollout(cfg: EnvConfig, num_games: int, device):
    """``seed -> (total int32[G, P], checksum f64[])``: the engine path's games
    with the board kept games-last across the generation (port of
    ``_make_pallas_generations``).  K2 deals, the board is transposed once,
    then per turn: the checksum from the games-last board, the pick from the
    ``STREAM_PLAY`` words, the games-last K1 and the sorted-hand shift."""
    G, R, T = num_games, cfg.num_rows, cfg.threshold

    def rollout(seed: int):
        board, row_len, hands_sorted = deal_games(cfg, seed, G, device=device)
        board_t, len_t = board.reshape(G, R * T).T.contiguous(), row_len.T.contiguous()
        words = random_pick_words(cfg, seed, G, device)
        total = torch.zeros((G, cfg.num_players), dtype=torch.int32, device=device)
        checksum = torch.zeros((), dtype=torch.float64, device=device)
        for t in range(cfg.max_turns):
            checksum = checksum + observation_sum_t(cfg, board_t, len_t, hands_sorted)
            actions = random_picks(hands_sorted, words[t])
            board_t, len_t, rewards_t = resolve_turn_t(cfg, board_t, len_t, actions)
            total = total + rewards_t.T
            hands_sorted = shift_hands(hands_sorted, actions)
        return total, checksum

    return rollout


def make_random_rollout_generations(cfg: EnvConfig, num_games: int, generations: int,
                                    fused: bool = False, games_last: bool = False, device="cuda"):
    """``seed -> (total int32[G, P], checksum f64[])`` over ``generations``
    back-to-back generations; generation ``g`` plays from seed ``seed + g``.

    ``fused=True`` runs each generation as one K3 launch; ``games_last=True``
    (the JAX ``use_pallas=True``) keeps the board games-last and resolves each
    turn with the games-last K1; otherwise the engine path of
    :func:`make_random_rollout`.  The two options exclude each other.
    """
    if fused and games_last:
        raise ValueError("fused and games_last are two different rollouts: pass one of them")
    dev = resolve_device(device)
    if games_last:
        play = _make_games_last_rollout(cfg, num_games, dev)
    elif fused:
        def play(seed: int):
            rewards, cs = play_random_games(cfg, seed, num_games, device=dev)
            return rewards, cs.sum(dtype=torch.float64)
    else:
        engine = make_random_rollout(cfg, num_games, dev)

        def play(seed: int):
            return engine(seed)[1:]

    def many(seed: int):
        total = torch.zeros((num_games, cfg.num_players), dtype=torch.int32, device=dev)
        checksum = torch.zeros((), dtype=torch.float64, device=dev)
        for g in range(generations):
            rewards, cs = play(seed + g)
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


def row_major_to_fm(obs, actions, rewards, next_obs):
    """``[T, G, P, ...]`` trajectories in the layout K4's feature-major emit
    gives: ``obs [S, (T+1)*P, G]`` (rows (f, t, p); the terminal observation is
    ``next_obs[T-1]``), ``actions`` and ``rewards [T*P, G]``.  The adapter that
    lets the engine rollout feed the feature-major cycle; it pays the
    transposes that the kernel's emit avoids."""
    T = obs.shape[0]
    return to_feature_major(torch.cat([obs, next_obs[T - 1:T]], dim=0), actions, rewards)


def to_transitions_fm(cfg: EnvConfig, gamma: float, n_steps: int, reward_lag: bool,
                      obs_fm, actions_fm, rewards_fm) -> dict:
    """:func:`to_transitions`' n-step math on the feature-major layout:
    ``obs_fm [S, (T+1)*P, G]``, ``actions_fm``/``rewards_fm [T*P, G]`` ->
    transitions with the slot axis last, in (t, p, g) order (``state [S, N]``,
    scalars ``[N]``, ``N = T*P*G``).  Every output is a slice, reshape or
    broadcast of the inputs, so the dict goes into ``per_add_batch(...,
    slot_axis=-1)`` as it is."""
    T, n = cfg.max_turns, n_steps
    S, G = obs_fm.shape[0], obs_fm.shape[2]
    P = obs_fm.shape[1] // (T + 1)
    N = T * P * G
    rew = rewards_fm.reshape(T, P, G).to(torch.float32)
    if reward_lag:
        rew = lag_rewards(rew)
    padded = torch.cat([rew, rew.new_zeros((n - 1, P, G))]) if n > 1 else rew
    disc = torch.tensor([gamma ** i for i in range(n)], dtype=torch.float32, device=rew.device)
    R = sum(disc[i] * padded[i: i + T] for i in range(n))                # [T, P, G]
    obs_r = obs_fm.reshape(S, T + 1, P, G)
    if n >= T:
        next_states = obs_r[:, T:].expand(S, T, P, G).reshape(S, N)
    elif n > 1:
        idx_next = torch.clamp(torch.arange(T, device=obs_fm.device) + n, max=T)
        next_states = obs_r[:, idx_next].reshape(S, N)
    else:
        next_states = obs_r[:, 1:].reshape(S, N)
    tail_start = (T - n + 1) if n > 1 else (T - 1)
    done = (torch.arange(T, device=obs_fm.device) >= tail_start)[:, None, None].expand(T, P, G)
    return {
        "state": obs_fm[:, : T * P].reshape(S, N),
        "action": actions_fm.reshape(N),
        "reward": R.reshape(N),
        "next_state": next_states,
        "done": done.reshape(N).to(torch.float32),
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
    axis_name=None,
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
    * ``per_init_fm`` with ``feature_major=True`` (PER configs): every leaf
      with its slot axis last, slots in (t, p, g) order -- the same multiset
      of transitions per cycle as row-major, in another slot order, so PER's
      stratified draws land on other transitions (PARITY_TORCH.md section
      18).  With ``kernel_act_rollout`` K4 emits the trajectory in this
      layout; the engine rollout goes through :func:`row_major_to_fm`;
    * ``per_init_aligned(cap, T*G*P, example)`` (or ``per_init_aligned_fm``
      with ``feature_major``) with ``per_aligned_capacity=cap`` (PER
      configs): each cycle's insert is one slice write that never wraps,
      with the ring's live set (:func:`..buffers.per.per_add_batch_aligned`);
    * ``per_init_kd(cap, S_PAD, SCAL_ROWS)`` with ``kernel_insert=True``: K5
      plays the games from ``deal_seed`` and writes the finished transitions
      into the planes itself (noisy PER configs with one hidden layer,
      ``n_steps >= max_turns``, ``num_games`` a multiple of 128, ``cap`` a
      multiple of ``T*P*128`` and at least ``T*P*num_games``); slot order
      (128-game tile, t, p, g) -- the same multiset of transitions per cycle
      as row-major, in another slot order.

    ``kernel_act_rollout=True`` (noisy configs with one hidden layer) plays
    the games in K4 from ``deal_seed``; the engine path otherwise.

    With ``axis_name`` (a process group or a tuple of them, see
    :func:`~..parallel.mesh.make_dp_dqn_step`) every Bellman update averages
    its gradients and loss over the ranks in one all-reduce, and the mean
    score is averaged at the cycle's end.
    """
    T, P, G = cfg.max_turns, cfg.num_players, num_games
    n = dqn_cfg.n_steps
    if feature_major and not dqn_cfg.per:
        raise ValueError("feature_major replay requires a PER config (per_init_fm / per_init_aligned_fm storage)")
    if kernel_insert:
        if not dqn_cfg.per:
            raise ValueError("kernel_insert requires a PER config (per_init_kd storage)")
        if not dqn_cfg.noisy:
            raise ValueError("kernel_insert requires a noisy config (greedy act)")
        if len(dqn_cfg.hidden_sizes) != 1:
            raise ValueError("kernel_insert supports one hidden layer")
        if n < T:
            raise ValueError("kernel_insert requires n_steps >= max_turns")
        if kernel_act_rollout or feature_major:
            raise ValueError("kernel_insert subsumes kernel_act_rollout/feature_major; pass kernel_insert alone")
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
    learn_step = make_learn_step(dqn_cfg, spec, optimizer, gamma, axis_name=axis_name)
    adv_head = 1 if dqn_cfg.dueling else 0
    play_kernel = make_act_rollout_kernel(cfg, G, hidden=dqn_cfg.hidden_sizes[0],
                                          feature_major=feature_major) if kernel_act_rollout else None
    slot_axis = -1 if (feature_major or kernel_insert) else 0

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
        if feature_major:   # K4's feature-major triple, straight to the harvest
            return obs_all, actions, rewards_i
        obs = obs_all[:T].to(store_dtype)
        next_obs = obs_all[1:].to(store_dtype)
        return obs, actions, rewards_i.to(torch.float32), next_obs, rewards_i.sum(dim=0)

    def learn_once(carry, t: int, u, noise):
        params, target_params, opt_state, buf = carry
        if dqn_cfg.per:
            buf, idx, weights, batch = per_sample(buf, u, dqn_cfg.minibatch, slot_axis=slot_axis)
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
            # Feature-major batches arrive [S, n]: back to rows for the learn math.
            rows = (lambda x: x.T) if feature_major else (lambda x: x)
            batch = {
                "state": rows(batch["state"].to(torch.float32)),
                "action": batch["action"].to(torch.int64),
                "reward": batch["reward"].to(torch.float32),
                "next_state": rows(batch["next_state"].to(torch.float32)),
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
            with span("cycle.rollout"):
                st = buf.storage
                insert = make_act_insert_kernel(cfg, G, dqn_cfg.hidden_sizes[0], buf.capacity,
                                                gamma, n, reward_lag)
                planes = insert(
                    rnd.deal_seed, buf.ptr, *act_weights(params, rnd),
                    st["state"], st["next_state"], st["scalars"])
            with span("cycle.insert"):
                buf = per_mark_batch(buf, dict(zip(("state", "next_state", "scalars"), planes[:3])),
                                     T * G * P)
            return buf, planes[3].reshape(T, P, G).to(torch.float32).sum(dim=0)
        store_dtype = buf.storage["state"].dtype
        if feature_major:
            with span("cycle.rollout"):
                if kernel_act_rollout:
                    obs_fm, actions_fm, rewards_fm = rollout_kernel(params, rnd, store_dtype)
                else:
                    obs_fm, actions_fm, rewards_fm = row_major_to_fm(*rollout(params, rnd, eps, store_dtype)[:4])
            with span("cycle.insert"):
                transitions = to_transitions_fm(cfg, gamma, n, reward_lag, obs_fm, actions_fm, rewards_fm)
                if per_aligned_capacity is not None:
                    buf = per_add_batch_aligned(buf, transitions, per_aligned_capacity, slot_axis=-1)
                else:
                    buf = per_add_batch(buf, transitions, slot_axis=-1)
            return buf, rewards_fm.reshape(T, P, G).to(torch.float32).sum(dim=0)
        with span("cycle.rollout"):
            if kernel_act_rollout:
                obs, actions, rewards, next_obs, scores = rollout_kernel(params, rnd, store_dtype)
            else:
                obs, actions, rewards, next_obs, scores = rollout(params, rnd, eps, store_dtype)
        with span("cycle.insert"):
            transitions = to_transitions(cfg, gamma, n, reward_lag, obs, actions, rewards, next_obs)
            if dqn_cfg.per and per_aligned_capacity is not None:
                buf = per_add_batch_aligned(buf, transitions, per_aligned_capacity)
            elif dqn_cfg.per:
                buf = per_add_batch(buf, transitions)
            else:
                buf = ring_add_batch(buf, transitions)
        return buf, scores

    def cycle(params, target_params, opt_state, buf, rng, eps, step0: int = 0):
        rnd = rng if isinstance(rng, CycleRandomness) else \
            draw_cycle_randomness(cfg, dqn_cfg, G, learn_iters, rng)
        # The three spans name the cycle's phases in a torch.profiler trace.
        buf, scores = play_and_insert(params, rnd, buf, eps)
        carry = (params, target_params, opt_state, buf)
        losses = []
        with span("cycle.learn"):
            for i in range(learn_iters):
                noise = rnd.learn_noise[i] if dqn_cfg.noisy else None
                carry, loss = learn_once(carry, step0 + i, rnd.per_uniforms[i], noise)
                losses.append(loss)
        params, target_params, opt_state, buf = carry
        metrics = {
            # each update's loss is averaged over the ranks already; no update (learn_iters=0) reads NaN, as
            # JAX's mean of no losses
            "loss": torch.stack(losses).mean() if losses else torch.full((), float("nan"), device=dev),
            "mean_score": pmean_fused(scores.to(torch.float32).mean(), axis_name),
        }
        return params, target_params, opt_state, buf, metrics

    return cycle


# ------------------------------------------------------- REINFORCE self-play


@dataclass
class Trajectory:
    """Per-turn records for every seat: leading axes ``[T, G, P]``."""

    obs: torch.Tensor          # f32[T, G, P, S]
    legal_cards: torch.Tensor  # i32[T, G, P, H]
    chosen: torch.Tensor       # i32[T, G, P] index into legal_cards
    reward: torch.Tensor       # f32[T, G, P] (current-step reward)


@dataclass
class RolloutRandomness:
    """Everything random one policy rollout consumes.

    * ``decks`` ``int[G, C]`` (dealt with ``init_from_deck``) or ``deal_seed``
      (dealt by K2 on the card, its twin on the CPU);
    * ``gumbel`` ``f32[T, G, P, H]``: turn t's pick is ``argmax(logits +
      gumbel[t])`` over the hand slots, which is ``jax.random.categorical``.
    """

    gumbel: torch.Tensor
    decks: Optional[torch.Tensor] = None
    deal_seed: Optional[int] = None


def draw_rollout_randomness(cfg: EnvConfig, num_games: int, generator: torch.Generator) -> RolloutRandomness:
    """Draw one rollout's :class:`RolloutRandomness` on the generator's device."""
    from ..agents.search import draw_gumbel

    dev = generator.device
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=dev).item())
    shape = (cfg.max_turns, num_games, cfg.num_players, cfg.hand_size)
    return RolloutRandomness(gumbel=draw_gumbel(generator, shape, dev), deal_seed=seed)


def _initial_state(cfg: EnvConfig, rnd: RolloutRandomness, num_games: int, dev):
    """The dealt games of ``rnd``, after checking its shapes."""
    want = (cfg.max_turns, num_games, cfg.num_players, cfg.hand_size)
    if tuple(rnd.gumbel.shape) != want:
        raise ValueError(f"gumbel has shape {tuple(rnd.gumbel.shape)}, expected {want}")
    if rnd.decks is not None and tuple(rnd.decks.shape) != (num_games, cfg.num_cards):
        raise ValueError(f"decks have shape {tuple(rnd.decks.shape)}, expected {(num_games, cfg.num_cards)}")
    if rnd.decks is not None:
        return init_from_deck(cfg, rnd.decks.to(dev))
    return deal(cfg, rnd.deal_seed, num_games, device=dev)


def _fold(x: torch.Tensor, num_games: int, cfg: EnvConfig) -> torch.Tensor:
    """``[T, G, P, ...] -> [G*P, T, ...]``: row ``g*P + p`` is seat (g, p)'s
    episode in time order."""
    return x.movedim(0, 2).reshape((num_games * cfg.num_players, cfg.max_turns) + tuple(x.shape[3:]))


def _pick(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """``categorical(logits)`` over the last axis as ``argmax(logits + gumbel)``; int64."""
    return torch.argmax(logits.detach() + gumbel.to(logits.device), dim=-1)


def make_reinforce_rollout(cfg: EnvConfig, spec: MLPSpec, num_games: int, device="cuda"):
    """``(params, rng) -> (Trajectory, scores int32[G, P])`` self-play with the
    action-in-input policy; ``rng`` is a :class:`RolloutRandomness` or a
    ``torch.Generator``.  On the card: one K2 deal and ten K1 turns."""
    dev = resolve_device(device)

    @torch.no_grad()
    def rollout(params, rng):
        rnd = rng if isinstance(rng, RolloutRandomness) else draw_rollout_randomness(cfg, num_games, rng)
        state = _initial_state(cfg, rnd, num_games, dev)
        recs = []
        for t in range(cfg.max_turns):
            obs, _ = observe(cfg, state)
            hands = state.hands_sorted
            idx = _pick(action_in_input_logits(spec, params, obs, hands), rnd.gumbel[t])
            state, rewards = step(cfg, state, onehot_select(hands, idx))
            recs.append((obs, hands, idx.to(torch.int32), rewards.to(torch.float32)))
        traj = Trajectory(*(torch.stack(x) for x in zip(*recs)))
        return traj, -state.scores

    return rollout


def make_reinforce_train_step(
    cfg: EnvConfig,
    spec: MLPSpec,
    optimizer: Adam,
    num_games: int,
    gamma: float = 0.99,
    r_factor: float = 1.0,
    actor_weight: float = 1.0,
    entropy_weight: float = 0.0,
    reward_lag: bool = True,
    fused_grad: bool = True,
    axis_name=None,
    device="cuda",
):
    """Self-play + one REINFORCE update over every seat of G games.

    ``train_step(params, opt_state, rng) -> (params, opt_state, {"loss",
    "mean_score"})`` with ``rng`` a :class:`RolloutRandomness` or a
    ``torch.Generator``.  The per-episode loss is the reference's
    (policy.py:174-196), averaged over the G x P seats; ``reward_lag`` keeps
    the session's lagged reward.

    ``fused_grad=True`` (the default) differentiates through the rollout's own
    policy forward: the turns are unrolled, each turn's forward runs on its
    ``H - t`` live hand slots only (padded back to H with ``NEG_INF``), one
    forward serves the pick (on detached logits) and the loss, and the
    backward runs through the whole rollout.  ``fused_grad=False`` plays under
    ``no_grad`` and recomputes the logits inside the loss.  The two give the
    same actions and the same loss to float round-off.  With ``axis_name`` (a
    process group or a tuple of them) the gradients, the loss and the mean
    score are averaged over the ranks in one all-reduce before the update.
    """
    dev = resolve_device(device)
    G, P, T, H = num_games, cfg.num_players, cfg.max_turns, cfg.hand_size
    rollout = make_reinforce_rollout(cfg, spec, G, dev)
    disc = torch.pow(gamma, torch.arange(T, dtype=torch.float32, device=dev))

    def episode_losses(chosen_logp, entropy, rewards):
        """Per-seat losses ``[...]`` from ``[T, ...]`` log-probs, entropies and raw rewards."""
        reward = (lag_rewards(rewards) if reward_lag else rewards).detach() * r_factor
        returns = discounted_returns(reward, gamma)
        extra = (1,) * (returns.dim() - 1)
        actor = -torch.sum(disc.view(T, *extra) * returns * chosen_logp, dim=0)
        return actor_weight * actor + entropy_weight * -torch.sum(entropy, dim=0)

    def fused_loss(live, rnd):
        state = _initial_state(cfg, rnd, G, dev)
        chosen_logp, entropy, rewards = [], [], []
        for t in range(T):
            obs, _ = observe(cfg, state)
            logits = action_in_input_logits(spec, live, obs, state.hands_sorted[:, :, : H - t])
            if t:
                logits = torch.cat([logits, logits.new_full((G, P, t), NEG_INF)], dim=-1)
            idx = _pick(logits, rnd.gumbel[t])
            logp, ent = log_probs_and_entropy(logits)
            chosen_logp.append(onehot_select(logp, idx))
            entropy.append(ent)
            state, r = step(cfg, state, onehot_select(state.hands_sorted, idx))
            rewards.append(r.to(torch.float32))
        losses = episode_losses(torch.stack(chosen_logp), torch.stack(entropy), torch.stack(rewards))
        return losses.mean(), -state.scores

    def recompute_loss(live, rnd):
        traj, scores = rollout(live, rnd)
        logits = action_in_input_logits(spec, live, traj.obs, traj.legal_cards)      # [T, G, P, H]
        logp, entropy = log_probs_and_entropy(logits)
        losses = episode_losses(onehot_select(logp, traj.chosen), entropy, traj.reward)
        return losses.mean(), scores

    loss_fn = fused_loss if fused_grad else recompute_loss

    def train_step(params, opt_state, rng):
        rnd = rng if isinstance(rng, RolloutRandomness) else draw_rollout_randomness(cfg, G, rng)
        # The three spans name the step's phases in a torch.profiler trace.
        with span("reinforce.rollout"):
            leaves, live = grad_leaves(params)
            loss, scores = loss_fn(live, rnd)
        with span("reinforce.backward"):
            grads = grads_of(loss, leaves, params)
        metrics = {"loss": loss.detach(), "mean_score": scores.to(torch.float32).mean()}
        if axis_name is not None:
            grads, metrics = pmean_fused((grads, metrics), axis_name)
        with span("reinforce.adam"):
            params, opt_state = optimizer_apply(optimizer, params, opt_state, grads)
        return params, opt_state, metrics

    return train_step


# ------------------------------------------------------------ ACER self-play


@dataclass
class AcerRandomness:
    """Everything random one ACER cycle consumes: the rollout's, the on-policy
    subsample ``on_idx int[k_on]`` (distinct, in ``[0, G*P)``; unused when the
    cycle trains on every fresh sequence) and the off-policy sample ``off_idx
    int[minibatch]`` (in ``[0, max(size, 1))`` of the buffer after the store)."""

    rollout: RolloutRandomness
    off_idx: torch.Tensor
    on_idx: Optional[torch.Tensor] = None


def acer_sequence_example(cfg: EnvConfig) -> dict:
    """One step of an ACER sequence, the example for ``seq_init``."""
    H = cfg.hand_size
    return {
        "state": torch.zeros(cfg.state_length, dtype=torch.float32),
        "legal_cards": torch.zeros(H, dtype=torch.int32),
        "log_probs": torch.zeros(H, dtype=torch.float32),
        "action_id": torch.zeros((), dtype=torch.int32),
        "reward": torch.zeros((), dtype=torch.float32),
        "done": torch.zeros((), dtype=torch.float32),
    }


def make_acer_rollout(cfg: EnvConfig, spec: MLPSpec, num_games: int, r_factor: float, device="cuda"):
    """``(params, rng) -> (seqs, scores int32[G, P])`` self-play with the
    actor-critic sampling policy (the host agent's ``forward``).

    ``seqs`` holds one sequence per seat, ``[G*P, T, ...]`` (row ``g*P + p``):
    the fields :func:`~..agents.acer.make_acer_train_step` reads, the current
    step's reward times ``r_factor`` (no lag, as the reference) and ``length``
    ``T``.  On the card: one K2 deal and ten K1 turns.
    """
    from ..agents.acer import actor_critic_heads

    dev = resolve_device(device)
    G, P, T = num_games, cfg.num_players, cfg.max_turns

    @torch.no_grad()
    def rollout(params, rng):
        rnd = rng if isinstance(rng, RolloutRandomness) else draw_rollout_randomness(cfg, G, rng)
        state = _initial_state(cfg, rnd, G, dev)
        recs = {k: [] for k in ("state", "legal_cards", "log_probs", "action_id", "reward", "done")}
        for t in range(T):
            obs, _ = observe(cfg, state)
            hands = state.hands_sorted
            log_probs, _ = actor_critic_heads(spec, params, obs, hands)
            idx = _pick(torch.where(hands >= 0, log_probs, -torch.inf), rnd.gumbel[t])
            state, rewards = step(cfg, state, onehot_select(hands, idx))
            for k, v in (("state", obs), ("legal_cards", hands), ("log_probs", log_probs),
                         ("action_id", idx.to(torch.int32)), ("reward", rewards.to(torch.float32) * r_factor),
                         ("done", torch.full((G, P), float(t == T - 1), device=dev))):
                recs[k].append(v)
        seqs = {k: _fold(torch.stack(v), G, cfg) for k, v in recs.items()}
        seqs["length"] = torch.full((G * P,), T, dtype=torch.int32, device=dev)
        return seqs, -state.scores

    return rollout


def make_acer_selfplay_step(
    cfg: EnvConfig,
    spec: MLPSpec,
    optimizer: Adam,
    num_games: int,
    gamma: float = 0.99,
    r_factor: float = 0.1,
    truncate: float = 1.0,
    minibatch: int = 64,
    actor_weight: float = 1.0,
    critic_weight: float = 1.0,
    on_policy_sequences: Optional[int] = 512,
    packed_rows: bool = False,
    axis_name=None,
    device="cuda",
):
    """ACER self-play cycle: rollout, sequence-buffer store, two updates.

    ``cycle(params, opt_state, buf, rng) -> (params, opt_state, buf,
    metrics)``: ``buf`` from ``seq_init(capacity, max_turns,
    acer_sequence_example(cfg))``, updated in place; ``rng`` an
    :class:`AcerRandomness` or a ``torch.Generator``.  One call plays G games,
    stores all ``G*P`` episode sequences, then runs one on-policy update on the
    fresh sequences and one off-policy update on a uniform ``minibatch`` of
    stored ones.  ``on_policy_sequences`` bounds the on-policy phase: ``None``
    trains on all ``G*P`` fresh sequences, an integer k on a uniform subsample
    of k of them without replacement (k clamps to ``G*P``, and at ``G*P`` the
    whole fresh batch is used, in order).  ``packed_rows`` selects the packed
    train step (the sequences are always full aligned episodes).  Metrics:
    the on-policy actor, correction and critic losses, the off-policy actor
    and critic losses and the mean score.  With ``axis_name`` (a process group
    or a tuple of them) both updates average their gradients over the ranks,
    and the mean score is averaged at the end.
    """
    from ..agents.acer import make_acer_train_step

    dev = resolve_device(device)
    G = num_games
    rollout = make_acer_rollout(cfg, spec, G, r_factor, dev)
    train = make_acer_train_step(spec, optimizer, gamma, truncate, actor_weight, critic_weight,
                                 packed_rows=packed_rows, axis_name=axis_name)
    n_fresh = G * cfg.num_players
    k_on = None if on_policy_sequences is None else min(on_policy_sequences, n_fresh)

    def cycle(params, opt_state, buf, rng):
        rnd = rng if isinstance(rng, AcerRandomness) else None
        # The four spans name the cycle's phases in a torch.profiler trace.
        with span("acer.rollout"):
            seqs, scores = rollout(params, rnd.rollout if rnd else draw_rollout_randomness(cfg, G, rng))
        with span("acer.store"):
            buf = seq_store_batch(buf, {k: v for k, v in seqs.items() if k != "length"}, seqs["length"])
        with span("acer.on"):
            on_batch = seqs
            if k_on is not None and k_on < n_fresh:
                if rnd is None:
                    idx = torch.randperm(n_fresh, generator=rng, device=rng.device)[:k_on]
                else:
                    idx = rnd.on_idx
                    if idx is None or idx.shape != (k_on,) or not 0 <= int(idx.min()) <= int(idx.max()) < n_fresh:
                        raise ValueError(f"expected {k_on} on-policy indices in [0, {n_fresh}), got {idx}")
                on_batch = {k: v[idx.to(dev)] for k, v in seqs.items()}
            params, opt_state, on_losses = train(params, opt_state, on_batch)
        with span("acer.off"):
            _, batch, lengths = seq_sample(buf, minibatch, idx=rnd.off_idx if rnd else None,
                                           generator=None if rnd else rng)
            params, opt_state, off_losses = train(params, opt_state, dict(batch, length=lengths))
        metrics = {
            "actor_loss": on_losses[0],
            "correction_loss": on_losses[1],
            "critic_loss": on_losses[2],
            "off_actor_loss": off_losses[0],
            "off_critic_loss": off_losses[2],
            "mean_score": pmean_fused(scores.to(torch.float32).mean(), axis_name),
        }
        return params, opt_state, buf, metrics

    return cycle
