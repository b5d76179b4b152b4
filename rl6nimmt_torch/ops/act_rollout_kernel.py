"""K4 and K5: whole greedy noisy-DQN games (port of ``ops/act_rollout_kernel.py``).

``make_act_rollout_kernel(cfg, num_games, hidden)`` returns ``play(seed, w1
[T,S,Hd], b1 [T,Hd], wa [T,Hd,A], ba [T,A]) -> (obs int8 [T+1,G,P,S],
actions int32 [T,G,P], rewards int32 [T,G,P])`` with ``T = cfg.max_turns``;
with ``feature_major=True`` it returns the same values in JAX's
feature-major layout, ``(obs int8 [S, (T+1)*P, G], actions int32 [T*P, G],
rewards int32 [T*P, G])``, rows in (f, t, p) order and games last: what the
feature-major replay insert takes with no relayout.
The games are dealt from ``seed`` by the same Philox deal as K2, so
``deal_games(seed)`` reproduces them.  Each turn every seat acts greedily on
the advantage head of that turn's effective weights (the dueling ``V -
mean(A)`` shift is a per-state constant and cannot change the argmax), over
the cards in its hand, lowest card first on ties -- ``argmax`` over the
legal-masked row.

On CUDA weights it launches ``csrc/act_rollout_kernel.cu`` (a CUDA block's
games share one forward spread over its threads; the built library's
``rl6_play_games()`` says how many): the entry ``rl6_act_rollout`` for the
row-major layout, ``rl6_act_rollout_fm`` (the same play loop, emitter
``csrc/feature_major_emit.cuh``) for the feature-major one, each with its own
launch counter.  On CPU weights it runs :func:`act_rollout_plain` or
:func:`act_rollout_fm_plain`.

``make_act_insert_kernel(cfg, num_games, hidden, capacity, gamma, n_steps,
reward_lag)`` returns ``insert(seed, ptr, w1, b1, wa, ba, state, next, scal)
-> (state, next, scal, rewards int32 [T*P, G])``: K4's games, whose finished
n-step transitions (lagged discounted returns, terminal bootstrap
observation, done tail; ``n_steps >= max_turns``) are written IN PLACE into
the :func:`..buffers.per.per_init_kd` planes -- int8 ``state``/``next``
``[S_PAD, cap]`` and f32 ``scal [SCAL_ROWS, cap]``, each starting on a
16-byte boundary -- at the columns of :func:`insert_columns`.  On CUDA
tensors it launches ``csrc/act_insert_kernel.cu``, which shares K4's play loop
(``csrc/act_play.cuh``); on CPU tensors it runs :func:`act_insert_plain`.
"""

from __future__ import annotations

import torch

from ..engine.env import observe, state_from_deal, step_with
from ..engine.state import EnvConfig
from . import _build
from .game_kernel import _check_cfg, _check_seed, deal_games_plain
from .step_kernel import resolve_turn_plain

NEG_INF = -1e9
MAX_HIDDEN = 256

_ROLLOUT = _build.Launcher("rl6_act_rollout", "act_rollout")
_ROLLOUT_FM = _build.Launcher("rl6_act_rollout_fm", "act_rollout_fm")
_INSERT = _build.Launcher("rl6_act_insert", "act_insert")


def act_rollout_plain(cfg: EnvConfig, seed: int, num_games: int, w1, b1, wa, ba):
    """Plain twin of K4: same deals (Philox), torch matmuls, masked argmax."""
    n_turns = cfg.max_turns
    board, row_len, hs = deal_games_plain(cfg, seed, num_games, w1.device)
    state = state_from_deal(cfg, board, row_len, hs)
    obs_all, actions_all, rewards_all = [], [], []
    for t in range(n_turns):
        obs, masks = observe(cfg, state)
        obs_all.append(obs.to(torch.int8))
        h = torch.relu(obs @ w1[t] + b1[t])
        adv = h @ wa[t] + ba[t]
        actions = torch.argmax(torch.where(masks, adv, NEG_INF), dim=-1).to(torch.int32)
        state, rewards = step_with(cfg, state, actions, resolve_turn_plain)
        actions_all.append(actions)
        rewards_all.append(rewards)
    obs_all.append(observe(cfg, state)[0].to(torch.int8))
    return torch.stack(obs_all), torch.stack(actions_all), torch.stack(rewards_all)


def to_feature_major(obs, actions, rewards):
    """K4's row-major outputs ``[T+1, G, P, S]``, ``[T, G, P]`` in the
    feature-major layout ``[S, (T+1)*P, G]``, ``[T*P, G]`` (contiguous)."""
    T1, G, P, S = obs.shape
    return (obs.permute(3, 0, 2, 1).reshape(S, T1 * P, G).contiguous(),
            actions.permute(0, 2, 1).reshape(-1, G).contiguous(),
            rewards.permute(0, 2, 1).reshape(-1, G).contiguous())


def act_rollout_fm_plain(cfg: EnvConfig, seed: int, num_games: int, w1, b1, wa, ba):
    """Plain twin of K4's feature-major emit: the row-major twin's outputs permuted."""
    return to_feature_major(*act_rollout_plain(cfg, seed, num_games, w1, b1, wa, ba))


def _check_tensors(kernel: str, device, specs):
    """Raise unless each ``(name, tensor, shape, dtype)`` matches and lies on ``device``."""
    for name, x, shape, dtype in specs:
        if tuple(x.shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, expected {shape}")
        if x.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if x.device != device:
            raise ValueError(f"{kernel}: every tensor must be on {device}, {name} is on {x.device}")


def _weight_specs(cfg: EnvConfig, hidden: int, w1, b1, wa, ba):
    T, S, A = cfg.max_turns, cfg.state_length, cfg.num_actions
    f32 = torch.float32
    return [("w1", w1, (T, S, hidden), f32), ("b1", b1, (T, hidden), f32),
            ("wa", wa, (T, hidden, A), f32), ("ba", ba, (T, A), f32)]


def _check_kernel_cfg(cfg: EnvConfig, hidden: int):
    if hidden > MAX_HIDDEN:
        raise ValueError(f"act kernels support hidden <= {MAX_HIDDEN}")
    if cfg.num_cards > 127:
        raise ValueError("int8 observations need card ids below 128")
    _check_cfg(cfg)


def make_act_rollout_kernel(cfg: EnvConfig, num_games: int, hidden: int, feature_major: bool = False):
    """Build ``play(seed, w1, b1, wa, ba)`` for ``num_games`` games (any G),
    in the row-major or (``feature_major``) the feature-major layout."""
    _check_kernel_cfg(cfg, hidden)
    G, P, S = num_games, cfg.num_players, cfg.state_length
    n_turns = cfg.max_turns
    name = "act_rollout_fm" if feature_major else "act_rollout"
    if feature_major:
        plain, launch = act_rollout_fm_plain, _ROLLOUT_FM
        shapes = ((S, (n_turns + 1) * P, G), (n_turns * P, G))
    else:
        plain, launch = act_rollout_plain, _ROLLOUT
        shapes = ((n_turns + 1, G, P, S), (n_turns, G, P))

    def play(seed, w1, b1, wa, ba):
        seed = _check_seed(seed)
        if w1.device.type == "cpu":
            return plain(cfg, seed, G, w1, b1, wa, ba)
        if w1.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {w1.device}")
        _check_tensors(name, w1.device, _weight_specs(cfg, hidden, w1, b1, wa, ba))
        dev = w1.device
        obs = torch.empty(shapes[0], dtype=torch.int8, device=dev)
        actions = torch.empty(shapes[1], dtype=torch.int32, device=dev)
        rewards = torch.empty(shapes[1], dtype=torch.int32, device=dev)
        if G:
            launch(dev.index, seed, w1.data_ptr(), b1.data_ptr(), wa.data_ptr(), ba.data_ptr(),
                   obs.data_ptr(), actions.data_ptr(), rewards.data_ptr(),
                   G, P, cfg.num_rows, cfg.threshold, cfg.hand_size, cfg.num_cards,
                   hidden, n_turns, int(cfg.include_summaries))
        return obs, actions, rewards

    return play


# ----------------------------------------------------- K5: direct replay insert

S_PAD = 48      # state rows of the int8 planes; rows S..S_PAD-1 stay zero
SCAL_ROWS = 8   # f32 scalar plane rows: 0 = n-step reward, 1 = action, 2 = done, rest zero
TILE = 128      # games a tile of the column map: the layout contract with the kd sampler


def insert_columns(cfg: EnvConfig, num_games: int, capacity: int, ptr: int, device) -> torch.Tensor:
    """``int64[T, P, G]``: the plane column K5 writes transition ``(t, p, g)`` to.

    Tile ``i = g // TILE`` owns the tile blocks from ``base_i = (ptr // TILE +
    i*T*P) % (capacity // TILE)``; game ``g`` writes column ``(base_i + t*P +
    p) * TILE + g % TILE``: one tile's columns run in ``(t, p, g)`` order.
    """
    T, P = cfg.max_turns, cfg.num_players
    g = torch.arange(num_games, device=device)
    tp = torch.arange(T * P, device=device).reshape(T, P, 1)
    blk = (ptr // TILE + (g // TILE) * T * P + tp) % (capacity // TILE)
    return blk * TILE + g % TILE


def act_insert_plain(cfg: EnvConfig, seed: int, num_games: int, w1, b1, wa, ba, ptr: int,
                     state, nxt, scal, gamma: float, n_steps: int, reward_lag: bool = True):
    """Plain twin of K5: K4's twin plays the games, the same f32 reverse
    recursion ``acc = r' + gamma * acc`` gives the returns (one rounded
    multiply, then one rounded add, as K5's ``__fmul_rn``/``__fadd_rn``), and
    the transitions are written in place at :func:`insert_columns`."""
    T, P, S, G = cfg.max_turns, cfg.num_players, cfg.state_length, num_games
    dev = state.device
    obs, actions, rewards = act_rollout_plain(cfg, seed, G, w1, b1, wa, ba)
    cols = insert_columns(cfg, G, state.shape[1], ptr, dev).reshape(-1)
    st = torch.zeros((state.shape[0], T, P, G), dtype=torch.int8, device=dev)
    st[:S] = obs[:T].permute(3, 0, 2, 1)
    nx = torch.zeros_like(st)
    nx[:S] = obs[T].permute(2, 1, 0)[:, None]
    rew = rewards.permute(0, 2, 1).to(torch.float32)                    # [T, P, G]
    g32 = torch.tensor(gamma, dtype=torch.float32, device=dev)
    acc = torch.zeros((P, G), dtype=torch.float32, device=dev)
    sc = torch.zeros((scal.shape[0], T, P, G), dtype=torch.float32, device=dev)
    for t in range(T - 1, -1, -1):
        if reward_lag:
            r = rew[t - 1] if t > 0 else torch.zeros_like(acc)
        else:
            r = rew[t]
        acc = r + g32 * acc
        sc[0, t] = acc
    tail_start = (T - n_steps + 1) if n_steps > 1 else (T - 1)
    sc[1] = actions.permute(0, 2, 1).to(torch.float32)
    sc[2] = (torch.arange(T, device=dev) >= tail_start).to(torch.float32)[:, None, None]
    state.index_copy_(1, cols, st.reshape(state.shape[0], -1))
    nxt.index_copy_(1, cols, nx.reshape(nxt.shape[0], -1))
    scal.index_copy_(1, cols, sc.reshape(scal.shape[0], -1))
    return state, nxt, scal, rewards.permute(0, 2, 1).reshape(T * P, G).contiguous()


def make_act_insert_kernel(cfg: EnvConfig, num_games: int, hidden: int, capacity: int,
                           gamma: float, n_steps: int, reward_lag: bool = True):
    """Build ``insert(seed, ptr, w1, b1, wa, ba, state, next, scal)`` (see the
    module docstring).  Requires ``num_games % TILE == 0``, ``n_steps >=
    cfg.max_turns``, ``capacity % (T*P*TILE) == 0`` and ``T*P*num_games <=
    capacity``; ``ptr`` must be a
    multiple of ``T*P*TILE`` in ``[0, capacity)``, which every insert of
    ``T*P*G`` transitions from ``ptr = 0`` keeps."""
    _check_kernel_cfg(cfg, hidden)
    T, P, S, G = cfg.max_turns, cfg.num_players, cfg.state_length, num_games
    region = T * P * TILE
    if G % TILE:
        raise ValueError(f"num_games={G} must be a multiple of {TILE} (one tile of the column map)")
    if n_steps < T:
        raise ValueError("direct-insert kernel requires n_steps >= max_turns")
    if capacity <= 0 or capacity % region:
        raise ValueError(f"capacity={capacity} must be a positive multiple of T*P*TILE={region}")
    if G * T * P > capacity:
        # Two tiles would own the same columns, and their blocks would race on them.
        raise ValueError(f"capacity={capacity} is below one insert of T*P*num_games={G * T * P}")
    if S > S_PAD:
        raise ValueError(f"direct-insert kernel needs state_length <= {S_PAD}")

    def insert(seed, ptr, w1, b1, wa, ba, state, nxt, scal):
        seed, ptr = _check_seed(seed), int(ptr)
        if not 0 <= ptr < capacity or ptr % region:
            raise ValueError(f"ptr={ptr} must be a multiple of T*P*TILE={region} in [0, {capacity})")
        dev = w1.device
        _check_tensors("act_insert", dev, _weight_specs(cfg, hidden, w1, b1, wa, ba) + [
            ("state", state, (S_PAD, capacity), torch.int8),
            ("next", nxt, (S_PAD, capacity), torch.int8),
            ("scal", scal, (SCAL_ROWS, capacity), torch.float32)])
        for name, x in (("state", state), ("next", nxt), ("scal", scal)):
            if x.data_ptr() % 16:   # the kernel stores 16 bytes of a plane row at once
                raise ValueError(f"act_insert: {name} must start on a 16-byte boundary")
        if dev.type == "cpu":
            return act_insert_plain(cfg, seed, G, w1, b1, wa, ba, ptr, state, nxt, scal,
                                    gamma, n_steps, reward_lag)
        if dev.type != "cuda":
            raise ValueError(f"act_insert: unsupported device {dev}")
        rewards = torch.empty((T * P, G), dtype=torch.int32, device=dev)
        if G:
            _INSERT(dev.index, seed, ptr, w1.data_ptr(), b1.data_ptr(), wa.data_ptr(), ba.data_ptr(),
                    state.data_ptr(), nxt.data_ptr(), scal.data_ptr(), rewards.data_ptr(),
                    G, P, cfg.num_rows, cfg.threshold, cfg.hand_size, cfg.num_cards, hidden, T,
                    int(cfg.include_summaries), capacity, S_PAD, SCAL_ROWS, gamma, n_steps,
                    int(reward_lag))
        return state, nxt, scal, rewards

    return insert
