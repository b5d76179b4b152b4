"""Plain reference of the 6 nimmt! rules, batched over games in plain PyTorch.

Written from the rules, not from the program under test (it imports nothing
of it):

* the deal: each game's deck is shuffled by a partial Fisher-Yates driven by
  Philox4x32-10 (Salmon et al., Random123), key ``(seed & 0xFFFFFFFF, seed >>
  32)``, counter ``(game, block, stream 0, 0)``, draw ``i`` word ``i % 4`` of
  block ``i // 4``, a draw below ``n`` the multiply-high ``(word * n) >> 32``.
  Seat ``p`` holds slots ``[p*H, (p+1)*H)`` sorted, row ``r`` starts with slot
  ``P*H + r``;
* a turn: every seat plays one card at once; the cards resolve in ascending
  order; a card joins the row whose last card is the highest below it; a card
  below every row takes the row of fewest points (the first on ties); a row
  taken, or one that reaches ``threshold`` cards with this one, costs its
  player the points of the cards it held, and restarts with the card played;
* a card's points (face ``id + 1``): 55 gives 7, multiples of 11 give 5,
  of 10 give 3, faces ending in 5 give 2, all others 1;
* a seat's observation: its hand ascending, ``-1`` padded to ``H`` | the number
  of players | cards a row | the last card of each row | the points of each
  row | the board, ``R x T`` with ``-1`` padding.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


@dataclass(frozen=True)
class Rules:
    num_players: int = 4
    num_rows: int = 4
    num_cards: int = 104
    threshold: int = 6
    hand_size: int = 10

    @property
    def obs_size(self) -> int:
        return self.hand_size + 1 + 3 * self.num_rows + self.num_rows * self.threshold


def rules_of(game: dict) -> Rules:
    """The :class:`Rules` of a configuration's ``game`` block."""
    if not game.get("include_summaries", True):
        raise ValueError("the reference observes with the row summaries")
    return Rules(*(int(game[k]) for k in ("num_players", "num_rows", "num_cards", "threshold", "hand_size")))


@dataclass
class Games:
    """``board int64[G, R, T]`` (-1 empty), ``length int64[G, R]``, ``hands
    int64[G, P, H]`` ascending and -1 padded, ``scores int64[G, P]``."""

    board: torch.Tensor
    length: torch.Tensor
    hands: torch.Tensor
    scores: torch.Tensor


def _mul32(a: torch.Tensor, m: int):
    """High and low 32-bit words of ``a * m`` (``a`` int64 below 2**32), in 16-bit limbs."""
    lo_part = a * (m & 0xFFFF)
    hi_part = a * (m >> 16)
    s = lo_part + ((hi_part & 0xFFFF) << 16)
    return (hi_part >> 16) + (s >> 32), s & MASK32


def philox_words(seed: int, games: torch.Tensor, n_words: int) -> torch.Tensor:
    """``int64[G, n_words]``: the first draws of each game's deal stream."""
    blocks = -(-n_words // 4)
    g = games.to(torch.int64)[:, None].expand(-1, blocks)
    b = torch.arange(blocks, dtype=torch.int64, device=games.device)[None, :].expand_as(g)
    c = [g, b, torch.zeros_like(g), torch.zeros_like(g)]
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mul32(c[0], PHILOX_M[0])
        hi1, lo1 = _mul32(c[2], PHILOX_M[1])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return torch.stack(c, dim=-1).reshape(games.shape[0], blocks * 4)[:, :n_words]


def deal(rules: Rules, seed: int, games: torch.Tensor) -> Games:
    """The games numbered ``games`` (int64 ids) of the deal of ``seed``."""
    P, H, R, T, C = rules.num_players, rules.hand_size, rules.num_rows, rules.threshold, rules.num_cards
    n = P * H + R
    G, dev = games.shape[0], games.device
    words = philox_words(int(seed), games, n)
    deck = torch.arange(C, device=dev, dtype=torch.int64).repeat(G, 1)
    rows = torch.arange(G, device=dev)
    for i in range(n):
        j = i + ((words[:, i] * (C - i)) >> 32)
        a, b = deck[:, i].clone(), deck[rows, j].clone()
        deck[:, i] = b
        deck[rows, j] = a
    hands = torch.sort(deck[:, : P * H].reshape(G, P, H), dim=-1).values
    board = torch.full((G, R, T), -1, dtype=torch.int64, device=dev)
    board[:, :, 0] = deck[:, P * H: n]
    length = torch.ones((G, R), dtype=torch.int64, device=dev)
    return Games(board, length, hands, torch.zeros((G, P), dtype=torch.int64, device=dev))


def points(card: torch.Tensor) -> torch.Tensor:
    """Points of each card id; 0 for -1."""
    face = card + 1
    p = torch.ones_like(card)
    p = torch.where(face % 10 == 5, 2, p)
    p = torch.where(face % 10 == 0, 3, p)
    p = torch.where(face % 11 == 0, 5, p)
    p = torch.where(face == 55, 7, p)
    return torch.where(card >= 0, p, 0)


def row_summaries(g: Games):
    """``(cards a row, last card a row, points a row)``, each ``[G, R]``."""
    last = torch.gather(g.board, 2, (g.length - 1)[..., None])[..., 0]
    return g.length, last, points(g.board).sum(dim=2)


def observe(rules: Rules, g: Games) -> torch.Tensor:
    """``f32[G, P, obs_size]``: every seat's observation."""
    G, P = g.hands.shape[:2]
    length, last, pts = row_summaries(g)
    shared = torch.cat([torch.full((G, 1), P, device=g.board.device, dtype=torch.int64), length, last, pts,
                        g.board.reshape(G, -1)], dim=1)
    return torch.cat([g.hands, shared[:, None, :].expand(G, P, shared.shape[1])], dim=2).to(torch.float32)


def play(rules: Rules, g: Games, cards: torch.Tensor):
    """One turn: ``cards int64[G, P]`` (each in its seat's hand).  Returns the
    next :class:`Games` and the rewards ``int64[G, P]`` (minus the points taken)."""
    G, P, R, T = cards.shape[0], rules.num_players, rules.num_rows, rules.threshold
    dev = cards.device
    board, length = g.board.clone(), g.length.clone()
    rewards = torch.zeros((G, P), dtype=torch.int64, device=dev)
    order = torch.argsort(cards, dim=1)
    rows_g = torch.arange(G, device=dev)
    for k in range(P):
        seat = order[:, k]
        card = cards[rows_g, seat]
        last = torch.gather(board, 2, (length - 1)[..., None])[..., 0]
        below = last < card[:, None]
        best_below = torch.argmax(torch.where(below, last, -1), dim=1)
        cheapest = torch.argmin(points(board).sum(dim=2), dim=1)
        undercut = ~below.any(dim=1)
        row = torch.where(undercut, cheapest, best_below)
        held = board[rows_g, row]                               # [G, T]
        n_held = length[rows_g, row]
        taken = undercut | (n_held + 1 >= T)
        penalty = torch.where(taken, points(held).sum(dim=1), 0)
        slot = torch.arange(T, device=dev)[None, :]
        appended = torch.where(slot == n_held[:, None], card[:, None], held)
        restarted = torch.where(slot == 0, card[:, None], torch.full_like(held, -1))
        board[rows_g, row] = torch.where(taken[:, None], restarted, appended)
        length[rows_g, row] = torch.where(taken, 1, n_held + 1)
        rewards[rows_g, seat] -= penalty
    played = g.hands == cards[..., None]
    kept = torch.where(played, rules.num_cards, g.hands)
    kept = torch.where(kept < 0, rules.num_cards + 1, kept)
    hands = torch.sort(kept, dim=-1).values
    hands = torch.where(hands >= rules.num_cards, -1, hands)
    return Games(board, length, hands, g.scores - rewards), rewards
