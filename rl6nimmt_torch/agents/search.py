"""Batched determinized playouts for the Monte-Carlo search agents (port of ``agents/search.py``).

A playout batch is B games played in lockstep on the batched engine: K
determinized initial states (unknown opponent hands re-dealt from the card
memory) per searched game, stacked along the engine's game axis.  Every turn
each player's move comes from the move rule -- uniform over the legal cards
(MCS) or sampled from the action-in-input policy net (PolicyMCS/PUCT), all
B x P players in one forward -- and then one :func:`~..engine.env.step`
resolves the turn (K1 on the card).

Player 0's first move is *forced* per playout (chosen by the variant's root
strategy -- uniform / policy sample / PUCT), which is how the sequential root
logic of the reference decomposes from the parallel playout bodies.

Randomness is explicit.  ``jax.random.categorical(key, logits)`` is
``argmax(logits + gumbel)`` with Gumbel noise of ``logits.shape`` drawn from
``key``; here the move rules take that Gumbel noise as tensors, one block
per turn: ``f32[n, B, P, C]`` for the uniform rule (over every card, masked
to the hand) and ``f32[n, B, P, H]`` for the net rule (over the hand slots).
:func:`draw_gumbel` draws it from a ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.env import _hands_mask, observe, step
from ..engine.state import EnvConfig, EnvState
from ..nets import MLPSpec
from ..utils.device import resolve_device
from .reinforce import action_in_input_logits

TINY = torch.finfo(torch.float32).tiny
POLICIES = ("uniform", "net", "mixed")


def draw_gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in ``[tiny, 1)``
    (the form ``jax.random.gumbel`` takes), drawn on the generator's device
    and moved to ``device``."""
    u = torch.rand(shape, generator=generator, device=generator.device).clamp_(min=TINY)
    return (-torch.log(-torch.log(u))).to(device)


def state_to(state: EnvState, device) -> EnvState:
    """``state`` with every field on ``device``."""
    return EnvState(*(torch.as_tensor(x, device=device) for x in
                      (state.board, state.row_len, state.hands, state.hands_sorted, state.scores, state.turn)))


def uniform_actions(hands: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """One uniform legal card per player: ``hands bool[..., C]``, ``gumbel f32[..., C]`` -> ``int32[...]``."""
    return torch.argmax(torch.where(hands, gumbel, -torch.inf), dim=-1).to(torch.int32)


def _policy_actions(spec: MLPSpec, params, obs, hands_sorted, gumbel) -> torch.Tensor:
    """Every player's move sampled from the shared action-in-input policy net:
    ``obs f32[..., S]``, ``hands_sorted int32[..., H]`` (-1 padded), ``gumbel
    f32[..., H]`` -> card ids ``int32[...]``."""
    logits = action_in_input_logits(spec, params, obs, hands_sorted)
    idx = torch.argmax(logits + gumbel, dim=-1)
    return torch.gather(hands_sorted, -1, idx[..., None]).squeeze(-1)


def make_single_playout(cfg: EnvConfig, policy: str, spec: MLPSpec | None):
    """The playout body shared by :func:`make_playout_fn` and the decision
    programs (:mod:`.device_search`).

    ``(params, states0, first_actions, n_turns, gumbel_uniform=None,
    gumbel_net=None, use_net=None) -> f32[B]``: player 0's summed reward over
    ``n_turns`` turns from the B-batched ``states0``, with player 0's first
    move forced to ``first_actions[b]`` (mcts.py:129-154).  The loop runs
    exactly ``n_turns`` turns: the decision depth leaves ``n = hand_size - t``
    cards, and all playouts of a call share it.

    ``policy="uniform"`` needs ``gumbel_uniform`` and ``"net"`` needs
    ``gumbel_net``.  ``"mixed"`` (the kind-traced decisions) takes a per-lane
    bool ``use_net`` and the noise of each rule its lanes use: given both, a
    lane plays the net rule where ``use_net`` and the uniform rule elsewhere,
    as the JAX body's ``where``; given one, every lane plays that rule.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown playout policy {policy!r}; choose from {POLICIES}")

    def single(params, states0: EnvState, first_actions, n_turns: int,
               gumbel_uniform=None, gumbel_net=None, use_net=None):
        rules = {"uniform": (True, False), "net": (False, True),
                 "mixed": (gumbel_uniform is not None, gumbel_net is not None)}[policy]
        if (rules[0] and gumbel_uniform is None) or (rules[1] and gumbel_net is None) or not any(rules):
            raise ValueError(f"a {policy!r} playout needs the Gumbel noise of its move rules")
        state = states0
        first = first_actions.to(torch.int32)
        ret = torch.zeros(first.shape[0], dtype=torch.float32, device=first.device)
        for t in range(n_turns):
            if rules[1]:
                obs, _ = observe(cfg, state)
                actions = _policy_actions(spec, params, obs, state.hands_sorted, gumbel_net[t])
            if rules[0]:
                uni = uniform_actions(state.hands, gumbel_uniform[t])
                actions = torch.where(use_net[:, None], actions, uni) if rules[1] else uni
            if t == 0:
                actions = torch.cat([first[:, None], actions[:, 1:]], dim=1)
            state, rewards = step(cfg, state, actions)
            ret = ret + rewards[:, 0]
        return ret

    return single


def make_playout_fn(cfg: EnvConfig, policy: str, spec: MLPSpec | None, device="cuda"):
    """``(params, states0, first_actions, n_turns, noise) -> f32[K]``.

    ``states0`` is a K-batched :class:`EnvState` (moved to ``device``);
    ``first_actions[k]`` is forced as player 0's move on the first turn of
    playout ``k``; the result is player 0's summed reward over exactly
    ``n_turns`` turns (mcts.py:129-154), a Python int that every playout of
    the call shares.  ``policy`` is ``"uniform"`` or ``"net"``.  ``noise`` is
    a ``torch.Generator``, from which the call draws its Gumbel noise
    (:func:`draw_gumbel`), or that noise itself: ``f32[n_turns, K, P, C]`` for
    the uniform rule, ``f32[n_turns, K, P, H]`` for the net rule.
    """
    if policy not in ("uniform", "net"):
        raise ValueError(f"make_playout_fn plays the 'uniform' or the 'net' rule, not {policy!r}")
    dev = resolve_device(device)
    single = make_single_playout(cfg, policy, spec)
    width = cfg.num_cards if policy == "uniform" else cfg.hand_size

    def playout(params, states0: EnvState, first_actions, n_turns: int, noise):
        first = torch.as_tensor(first_actions, device=dev)
        shape = (n_turns, first.shape[0], cfg.num_players, width)
        gumbel = (draw_gumbel(noise, shape, dev) if isinstance(noise, torch.Generator)
                  else torch.as_tensor(noise, device=dev))
        key = "gumbel_uniform" if policy == "uniform" else "gumbel_net"
        return single(params, state_to(states0, dev), first, n_turns, **{key: gumbel})

    return playout


def build_root_states_batch(
    cfg: EnvConfig,
    boards_rows: list,
    my_hands: list,
    opponent_hands: np.ndarray,
    device="cuda",
) -> EnvState:
    """Root states for G games x K determinizations each, on ``device``.

    ``boards_rows[g]`` / ``my_hands[g]`` describe game ``g``'s shared board
    and searcher hand, ``opponent_hands`` is ``int[G, K, P-1, n]``.  Returns a
    game-major ``[G*K]``-batched :class:`EnvState`.
    """
    dev = resolve_device(device)
    G, K, Pm1, n = opponent_hands.shape
    R, T, P, C, H = cfg.num_rows, cfg.threshold, cfg.num_players, cfg.num_cards, cfg.hand_size
    if Pm1 != P - 1 or len(boards_rows) != G or len(my_hands) != G:
        raise ValueError("boards_rows, my_hands and opponent_hands must describe the same G games of P players")

    board = np.full((G, R, T), -1, dtype=np.int32)
    row_len = np.zeros((G, R), dtype=np.int32)
    hands_sorted = np.full((G, K, P, H), -1, dtype=np.int32)
    for g in range(G):
        for r, cards in enumerate(boards_rows[g]):
            board[g, r, : len(cards)] = cards
            row_len[g, r] = len(cards)
        hands_sorted[g, :, 0, : len(my_hands[g])] = sorted(my_hands[g])
    hands_sorted[:, :, 1:, :n] = np.sort(opponent_hands, axis=3)

    B = G * K
    hs = torch.from_numpy(hands_sorted.reshape(B, P, H)).to(dev)
    return EnvState(
        board=torch.from_numpy(np.repeat(board, K, axis=0)).to(dev),
        row_len=torch.from_numpy(np.repeat(row_len, K, axis=0)).to(dev),
        hands=_hands_mask(cfg, hs),
        hands_sorted=hs,
        scores=torch.zeros((B, P), dtype=torch.int32, device=dev),
        turn=torch.zeros((B,), dtype=torch.int32, device=dev),
    )


def build_root_state(
    cfg: EnvConfig,
    board_rows: list,
    my_hand: list,
    opponent_hands: np.ndarray,
    device="cuda",
) -> EnvState:
    """A K-batched mid-game state for one determinization batch.

    ``opponent_hands`` is ``int[K, P-1, n]`` of card ids per playout; the
    board and player-0 hand are shared across the batch.  (Single-game
    convenience over :func:`build_root_states_batch`.)
    """
    return build_root_states_batch(cfg, [board_rows], [my_hand], opponent_hands[None], device)
