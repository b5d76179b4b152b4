"""Philox4x32-10 known answers and the port's Philox deals vs JAX init_from_deck."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl6nimmt_tpu.engine import EnvConfig as JaxConfig
from rl6nimmt_tpu.engine import env as jenv
from rl6nimmt_torch.engine import EnvConfig
from rl6nimmt_torch.ops.game_kernel import deal_decks_plain, deal_games, deal_games_plain
from rl6nimmt_torch.ops.philox import STREAM_DEAL, draw_below, philox4x32, philox_words

M = 0xFFFFFFFF


@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M, M, M, M), (M, M), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_random123_known_answers(ctr, key, expect):
    out = philox4x32(*ctr, *key)
    assert tuple(int(w) for w in out) == expect


def test_words_follow_counter_layout():
    """Word i of a game's stream is lane i % 4 of block i // 4."""
    seed = (5 << 32) | 9
    words = philox_words(seed, torch.tensor([3]), STREAM_DEAL, 9)
    for i in range(9):
        blk = philox4x32(3, i // 4, STREAM_DEAL, 0, 9, 5)
        assert int(words[0, i]) == int(blk[i % 4])


def test_multiply_high_draws_stay_in_range():
    w = torch.tensor([0, 1, M // 2, M], dtype=torch.int64)
    for n in (1, 7, 104):
        d = draw_below(w, n)
        assert int(d.min()) >= 0 and int(d.max()) < n
    assert int(draw_below(torch.tensor([M]), 104)) == 103


@pytest.mark.parametrize("num_players", [2, 4, 6])
def test_philox_deal_is_a_valid_permutation_and_matches_jax_init(num_players):
    cfg, jcfg = EnvConfig(num_players), JaxConfig(num_players)
    decks = deal_decks_plain(cfg, seed=1234, num_games=16, device="cpu")
    assert torch.equal(torch.sort(decks, dim=1).values, torch.arange(104).expand(16, 104))
    board, row_len, hands = deal_games_plain(cfg, 1234, 16, "cpu")
    js = jax.vmap(functools.partial(jenv.init_from_deck, jcfg))(jnp.asarray(decks.numpy()))
    np.testing.assert_array_equal(np.asarray(js.board), board.numpy())
    np.testing.assert_array_equal(np.asarray(js.row_len), row_len.numpy())
    np.testing.assert_array_equal(np.asarray(js.hands_sorted), hands.numpy())


def test_deal_entry_point_on_cpu_and_seed_sensitivity():
    cfg = EnvConfig(4)
    a = deal_games(cfg, 1, 8, device="cpu")
    b = deal_games(cfg, 1, 8, device="cpu")
    c = deal_games(cfg, 2, 8, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[2], c[2])
    # Games of one call differ from each other (the game index is in the counter).
    assert not torch.equal(a[2][0], a[2][1])


def test_deal_card_frequencies_are_uniform():
    """Each card lands in seat 0's hand with probability H/C."""
    cfg = EnvConfig(4)
    _, _, hands = deal_games_plain(cfg, 99, 4096, "cpu")
    counts = torch.bincount(hands[:, 0].reshape(-1).long(), minlength=104).double()
    expected = 4096 * 10 / 104
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 103 + 6 * (2 * 103) ** 0.5     # ~6 sigma of a chi^2(103)
