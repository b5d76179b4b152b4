"""Batched 6 nimmt! engine in PyTorch (port of ``engine/env.py``).

Every function works on a batch of ``G`` games (leading axis) with no vmap:

* :func:`init_from_deck` / :func:`deal` -- dealing (reference env.py:99-112);
  ``deal`` goes through the K2 deal kernel on the card.
* :func:`step` -- one simultaneous turn.  Board resolution (P sub-plays in
  ascending card order) goes through the K1 kernel on the card
  (``ops.step_kernel.resolve_turn``); the hand mask and the sorted-hand shift
  stay in torch, as in the JAX ``step``.
* :func:`observe` -- the 47-dim per-player observation plus the legal mask.
* :func:`is_done` -- hand-0-empty termination.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .state import EnvConfig, EnvState


class InvalidMoveException(Exception):
    """Host-side error for illegal moves (reference env.py:9-10)."""


def card_points_formula(card: torch.Tensor) -> torch.Tensor:
    """Card point values computed arithmetically; negative ids give 0."""
    face = card + 1
    m10 = face % 10
    pts = torch.where(
        face == 55, 7,
        torch.where(face % 11 == 0, 5,
                    torch.where(m10 == 0, 3, torch.where(m10 == 5, 2, 1))),
    )
    return torch.where(card >= 0, pts, 0).to(torch.int32)


# --------------------------------------------------------------------- dealing


def _hands_mask(cfg: EnvConfig, hands_sorted: torch.Tensor) -> torch.Tensor:
    """``bool[G, P, C]`` membership from ``-1``-padded sorted hands."""
    cards = torch.arange(cfg.num_cards, device=hands_sorted.device, dtype=torch.int32)
    return (hands_sorted[..., :, None] == cards).any(dim=-2)


def state_from_deal(cfg: EnvConfig, board, row_len, hands_sorted) -> EnvState:
    """Initial :class:`EnvState` from a dealt board and sorted hands."""
    G, P = board.shape[0], cfg.num_players
    dev = board.device
    return EnvState(
        board=board.to(torch.int32),
        row_len=row_len.to(torch.int32),
        hands=_hands_mask(cfg, hands_sorted),
        hands_sorted=hands_sorted.to(torch.int32),
        scores=torch.zeros((G, P), dtype=torch.int32, device=dev),
        turn=torch.zeros((G,), dtype=torch.int32, device=dev),
    )


def init_from_deck(cfg: EnvConfig, decks: torch.Tensor) -> EnvState:
    """Initial states from explicit shuffled decks ``int[G, C]``.

    Player ``p`` holds ``deck[p*H:(p+1)*H]`` (sorted) and board row ``r`` is
    seeded with ``deck[C - 1 - r]`` (reference env.py:99-112 layout).
    """
    P, C, H, R, T = (cfg.num_players, cfg.num_cards, cfg.hand_size,
                     cfg.num_rows, cfg.threshold)
    decks = decks.to(torch.int32)
    G = decks.shape[0]
    hands_sorted = torch.sort(decks[:, : P * H].reshape(G, P, H), dim=-1).values
    seeds = decks[:, C - 1 - torch.arange(R, device=decks.device)]
    board = torch.full((G, R, T), -1, dtype=torch.int32, device=decks.device)
    board[:, :, 0] = seeds
    row_len = torch.ones((G, R), dtype=torch.int32, device=decks.device)
    return state_from_deal(cfg, board, row_len, hands_sorted)


def deal(cfg: EnvConfig, seed: int, num_games: int, device="cuda") -> EnvState:
    """Deal ``num_games`` fresh games from Philox ``seed`` (K2 on the card)."""
    from ..ops.game_kernel import deal_games

    board, row_len, hands_sorted = deal_games(cfg, seed, num_games, device=device)
    return state_from_deal(cfg, board, row_len, hands_sorted)


# --------------------------------------------------------------------- scoring


def row_points(cfg: EnvConfig, board: torch.Tensor, row_len: torch.Tensor) -> torch.Tensor:
    """Total points per row including the last card: ``int32[..., R]``."""
    slot = torch.arange(cfg.threshold, device=board.device)
    pts = card_points_formula(board)
    return torch.where(slot < row_len[..., None], pts, 0).sum(dim=-1, dtype=torch.int32)


def row_lasts(board: torch.Tensor, row_len: torch.Tensor) -> torch.Tensor:
    """Last (= highest) card of each row: ``int32[..., R]``."""
    return torch.gather(board, -1, (row_len.long() - 1).unsqueeze(-1)).squeeze(-1)


# ------------------------------------------------------------------------ step


def _resolve(cfg: EnvConfig, board, row_len, card):
    """Place one card per game; return ``(board', row_len', penalty[G])``.

    The card joins the row whose last card is the highest below it; an
    undercut captures the cheapest row (first minimum on ties).  A capture --
    by undercut or by reaching ``threshold`` cards -- costs the points of the
    whole old row and restarts the row with the placed card.
    """
    R, T = cfg.num_rows, cfg.threshold
    dev = board.device
    slot = torch.arange(T, device=dev)
    rows = torch.arange(R, device=dev)

    lasts = row_lasts(board, row_len)                                 # [G, R]
    fits = lasts < card[:, None]
    target = torch.argmax(torch.where(fits, lasts, -1), dim=1)
    undercut = ~fits.any(dim=1)
    points = row_points(cfg, board, row_len)
    cheapest = torch.argmin(points, dim=1)
    row = torch.where(undercut, cheapest, target)

    is_row = rows[None, :] == row[:, None]                            # [G, R]
    old_len = torch.where(is_row, row_len, 0).sum(dim=1, dtype=torch.int32)
    old_points = torch.where(is_row, points, 0).sum(dim=1, dtype=torch.int32)
    captures = undercut | (old_len + 1 >= T)

    c = card[:, None, None]
    appended = torch.where(slot == old_len[:, None, None], c, board)
    restarted = torch.where(slot == 0, c, torch.full_like(board, -1))
    new_rows = torch.where(captures[:, None, None], restarted, appended)
    board = torch.where(is_row[:, :, None], new_rows, board)
    row_len = torch.where(
        is_row, torch.where(captures, 1, old_len + 1)[:, None], row_len
    ).to(torch.int32)
    penalty = torch.where(captures, old_points, 0).to(torch.int32)
    return board.to(torch.int32), row_len, penalty


def step(cfg: EnvConfig, state: EnvState, actions: torch.Tensor) -> Tuple[EnvState, torch.Tensor]:
    """One simultaneous turn for every game; ``actions`` is ``int[G, P]``.

    Returns the new state and the per-player rewards ``int32[G, P]`` (0 or
    minus the captured points).  Legality is not checked.  The board
    resolution is K1 on the card (``ops.step_kernel.resolve_turn``).
    """
    from ..ops.step_kernel import resolve_turn

    return step_with(cfg, state, actions, resolve_turn)


def step_with(cfg: EnvConfig, state: EnvState, actions: torch.Tensor, resolve):
    """:func:`step` with an explicit board resolver (the plain twins pass
    ``ops.step_kernel.resolve_turn_plain`` so they never launch a kernel)."""
    actions = actions.to(torch.int32).contiguous()
    board, row_len, rewards = resolve(cfg, state.board, state.row_len, actions)

    cards = torch.arange(cfg.num_cards, device=actions.device, dtype=torch.int32)
    hands = state.hands & (cards != actions[..., None])

    return EnvState(
        board=board,
        row_len=row_len,
        hands=hands,
        hands_sorted=shift_hands(state.hands_sorted, actions),
        scores=state.scores - rewards,
        turn=state.turn + 1,
    ), rewards


def shift_hands(hands_sorted: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Take each seat's played card out of its sorted, ``-1``-padded hand: the
    cards above it move down one slot."""
    hs = hands_sorted
    slot = torch.arange(hs.shape[-1], device=hs.device)
    pos = torch.argmax((hs == actions[..., None]).to(torch.int8), dim=-1)   # unique slot
    shifted = torch.cat([hs[..., 1:], torch.full_like(hs[..., :1], -1)], dim=-1)
    return torch.where(slot >= pos[..., None], shifted, hs)


# ---------------------------------------------------------------- observations


def sorted_hands(cfg: EnvConfig, hands: torch.Tensor) -> torch.Tensor:
    """Ascending card ids per player, -1 padded: ``int32[..., P, hand_size]``
    from the card-membership mask ``bool[..., P, C]`` (the reference's
    sorted-hand observation block, env.py:206-212).  The held cards' ids,
    non-held lanes pushed past them, are the ascending hand."""
    C, H = hands.shape[-1], cfg.hand_size
    ids = torch.where(hands, torch.arange(C, device=hands.device), C)
    first = torch.sort(ids, dim=-1).values[..., :H]
    return torch.where(first == C, -1, first).to(torch.int32)


def game_features(cfg: EnvConfig, board, row_len) -> torch.Tensor:
    """The per-game observation block shared by every seat: ``int32[G, S-H]``.

    ``num_players | [cards/row | highest/row | points/row] | board R*T``.
    """
    G = board.shape[0]
    pieces = [torch.full((G, 1), cfg.num_players, dtype=torch.int32, device=board.device)]
    if cfg.include_summaries:
        pieces += [row_len, row_lasts(board, row_len), row_points(cfg, board, row_len)]
    pieces.append(board.reshape(G, -1))
    return torch.cat([p.to(torch.int32) for p in pieces], dim=1)


def observe(cfg: EnvConfig, state: EnvState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-player observations ``f32[G, P, S]`` plus the legal mask ``bool[G, P, C]``.

    Layout (reference env.py:174-212): ``hand(10) | num_players |
    [cards/row | highest/row | points/row] | board RxT``.
    """
    game = game_features(cfg, state.board, state.row_len)
    G, P = state.hands_sorted.shape[:2]
    obs = torch.cat(
        [state.hands_sorted, game[:, None, :].expand(G, P, game.shape[1])], dim=2
    )
    return obs.to(torch.float32), state.hands


def legal_mask(state: EnvState) -> torch.Tensor:
    """Legal-action mask ``bool[G, P, C]`` -- the hand membership."""
    return state.hands


def is_done(state: EnvState) -> torch.Tensor:
    """``bool[G]``: game over when player 0 has no cards left."""
    return ~state.hands[:, 0].any(dim=-1)
