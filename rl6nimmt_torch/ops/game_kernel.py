"""K2 (dealing) and K3 (whole random games), port of ``ops/game_kernel.py``.

* ``deal_games(cfg, seed, G)`` -> ``(board[G,R,T], row_len[G,R],
  hands_sorted[G,P,H])`` in ``init_from_deck`` layout.  On the card it
  launches ``rl6_deal_games`` (``csrc/game_kernel.cu``): a partial
  Fisher-Yates over the P*H + R dealt positions of a deck in shared memory,
  driven by Philox stream ``STREAM_DEAL``, with each seat's hand a card set
  (``csrc/game.cuh``), so the hands need no sort.  It deals the games of the
  play loop's ``deal()`` (K4-K6).
* ``play_random_games(cfg, seed, G)`` -> ``(rewards[G,P], checksum[G])``:
  deal plus ``max_turns`` turns of uniform-legal random play and the
  per-game observation checksum (sum of every observation entry of every
  turn, as the TPU kernel defined it).  Picks come from stream
  ``STREAM_PLAY``: seat ``p`` at turn ``t`` takes hand slot
  ``(word[t*P + p] * count) >> 32``.

The plain twins consume the same Philox words in the same order, so on the
card K2 and K3 equal them bit for bit.  The TPU's 24-bit-key bitonic shuffle
(``game_kernel.py:90-140``) is replaced by the Fisher-Yates deal; see
``PARITY_TORCH.md``.
"""

from __future__ import annotations

import torch

from ..engine.env import observe, state_from_deal, step_with
from ..engine.state import EnvConfig
from ..utils.device import resolve_device
from . import _build
from .philox import STREAM_DEAL, STREAM_PLAY, draw_below, philox_words
from .step_kernel import resolve_turn_plain

_DEAL = _build.Launcher("rl6_deal_games", "deal_games")
_PLAY = _build.Launcher("rl6_play_random_games", "play_random_games")


def _check_cfg(cfg: EnvConfig) -> None:
    if cfg.num_cards > 128 or cfg.num_players > 16 or cfg.num_rows > 8 \
            or cfg.threshold > 8 or cfg.hand_size > 16:
        raise ValueError("game kernels support C <= 128, P <= 16, R <= 8, T <= 8, H <= 16")


def _check_seed(seed) -> int:
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be an unsigned 64-bit int, got {seed}")
    return seed


# ----------------------------------------------------------------- plain twins


def _fisher_yates(cfg: EnvConfig, seed: int, num_games: int, device) -> torch.Tensor:
    """``int64[G, C]`` decks whose first ``P*H + R`` slots are the partial
    Fisher-Yates draws of each game's ``STREAM_DEAL`` stream."""
    C = cfg.num_cards
    n = cfg.num_players * cfg.hand_size + cfg.num_rows
    games = torch.arange(num_games, device=device)
    words = philox_words(seed, games, STREAM_DEAL, n)
    deck = torch.arange(C, device=device).repeat(num_games, 1)
    for i in range(n):
        j = i + draw_below(words[:, i], C - i)
        di = deck[:, i].clone()
        deck[:, i] = deck[games, j]
        deck[games, j] = di
    return deck


def deal_decks_plain(cfg: EnvConfig, seed: int, num_games: int, device="cuda") -> torch.Tensor:
    """Full decks ``int32[G, C]`` such that ``init_from_deck(decks)`` is the
    deal of ``seed``: hands from slots ``[0, P*H)``, row ``r`` from slot
    ``C-1-r``, the undealt cards in between."""
    d = _fisher_yates(cfg, _check_seed(seed), num_games, resolve_device(device))
    PH, R = cfg.num_players * cfg.hand_size, cfg.num_rows
    return torch.cat([d[:, :PH], d[:, PH + R:], d[:, PH:PH + R].flip(1)], dim=1).to(torch.int32)


def deal_games_plain(cfg: EnvConfig, seed: int, num_games: int, device="cuda"):
    """Plain twin of K2: ``(board, row_len, hands_sorted)``, all int32."""
    P, H, R, T = cfg.num_players, cfg.hand_size, cfg.num_rows, cfg.threshold
    d = _fisher_yates(cfg, _check_seed(seed), num_games, resolve_device(device))
    G = num_games
    hands = torch.sort(d[:, : P * H].reshape(G, P, H), dim=-1).values.to(torch.int32)
    board = torch.full((G, R, T), -1, dtype=torch.int32, device=d.device)
    board[:, :, 0] = d[:, P * H: P * H + R].to(torch.int32)
    row_len = torch.ones((G, R), dtype=torch.int32, device=d.device)
    return board, row_len, hands


def random_pick_words(cfg: EnvConfig, seed: int, num_games: int, device="cuda") -> torch.Tensor:
    """``int64[T, G, P]``: the ``STREAM_PLAY`` word of each seat's pick."""
    n_turns, P = cfg.max_turns, cfg.num_players
    games = torch.arange(num_games, device=resolve_device(device))
    words = philox_words(_check_seed(seed), games, STREAM_PLAY, n_turns * P)
    return words.reshape(num_games, n_turns, P).permute(1, 0, 2)


def random_picks(hands_sorted: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Uniform-legal card per seat: hand slot ``(word * count) >> 32`` of
    the ``-1``-padded sorted hand, as K3 picks."""
    r = draw_below(words, (hands_sorted >= 0).sum(dim=-1))
    return torch.gather(hands_sorted, -1, r[..., None]).squeeze(-1)


def play_random_games_plain(cfg: EnvConfig, seed: int, num_games: int, device="cuda"):
    """Plain twin of K3: ``(rewards int32[G,P], checksum f32[G])``, played on
    the engine with the plain resolver."""
    dev = resolve_device(device)
    state = state_from_deal(cfg, *deal_games_plain(cfg, seed, num_games, dev))
    words = random_pick_words(cfg, seed, num_games, dev)
    total = torch.zeros((num_games, cfg.num_players), dtype=torch.int32, device=dev)
    checksum = torch.zeros(num_games, dtype=torch.int64, device=dev)
    for t in range(cfg.max_turns):
        checksum += observe(cfg, state)[0].to(torch.int64).sum(dim=(1, 2))
        state, rewards = step_with(cfg, state, random_picks(state.hands_sorted, words[t]), resolve_turn_plain)
        total += rewards
    # Integer-valued and < 2**24 per game, so the f32 value is exact.
    return total, checksum.to(torch.float32)


# -------------------------------------------------------------------- wrappers


def deal_games(cfg: EnvConfig, seed: int, num_games: int, device="cuda"):
    """K2 on the card, the plain twin for ``device="cpu"``."""
    dev = resolve_device(device)
    seed = _check_seed(seed)
    if dev.type == "cpu":
        return deal_games_plain(cfg, seed, num_games, dev)
    _check_cfg(cfg)
    G, P, H, R, T = num_games, cfg.num_players, cfg.hand_size, cfg.num_rows, cfg.threshold
    board = torch.empty((G, R, T), dtype=torch.int32, device=dev)
    row_len = board.new_empty((G, R))
    hands = board.new_empty((G, P, H))
    if G:
        _DEAL(board.get_device(), seed, board.data_ptr(), row_len.data_ptr(), hands.data_ptr(),
              G, P, R, T, H, cfg.num_cards)
    return board, row_len, hands


def play_random_games(cfg: EnvConfig, seed: int, num_games: int, device="cuda"):
    """K3 on the card, the plain twin for ``device="cpu"``."""
    dev = resolve_device(device)
    seed = _check_seed(seed)
    if dev.type == "cpu":
        return play_random_games_plain(cfg, seed, num_games, dev)
    _check_cfg(cfg)
    G, P = num_games, cfg.num_players
    rewards = torch.empty((G, P), dtype=torch.int32, device=dev)
    checksum = torch.empty((G,), dtype=torch.float32, device=dev)
    if G:
        _PLAY(rewards.get_device(), seed, rewards.data_ptr(), checksum.data_ptr(),
              G, P, cfg.num_rows, cfg.threshold, cfg.hand_size, cfg.num_cards, int(cfg.include_summaries))
    return rewards, checksum
