"""Port engine vs the JAX engine on shared numpy decks: bit-exact every turn."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl6nimmt_tpu.engine import EnvConfig as JaxConfig
from rl6nimmt_tpu.engine import env as jenv
from rl6nimmt_tpu.engine.cards import POINTS_104 as JAX_POINTS
from rl6nimmt_torch.engine import EnvConfig, POINTS_104, card_points_formula, env as tenv
from rl6nimmt_torch.ops.step_kernel import resolve_turn, resolve_turn_plain

G = 8


def _decks(rng, n, C=104):
    return np.stack([rng.permutation(C) for _ in range(n)]).astype(np.int32)


def _jax_fns(jcfg):
    return (jax.jit(jax.vmap(functools.partial(jenv.init_from_deck, jcfg))),
            jax.jit(jax.vmap(functools.partial(jenv.step, jcfg))),
            jax.jit(jax.vmap(functools.partial(jenv.observe, jcfg))),
            jax.jit(jax.vmap(functools.partial(jenv.row_points, jcfg))))


def _assert_state(js, ts, msg):
    for name in ("board", "row_len", "hands", "hands_sorted", "scores", "turn"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy(), err_msg=f"{name} {msg}")


@pytest.mark.parametrize("include_summaries", [True, False])
@pytest.mark.parametrize("num_players", [2, 3, 4, 6])
def test_engine_matches_jax_every_turn(num_players, include_summaries):
    jcfg = JaxConfig(num_players, include_summaries=include_summaries)
    cfg = EnvConfig(num_players, include_summaries=include_summaries)
    init_j, step_j, obs_j, rowpts_j = _jax_fns(jcfg)
    rng = np.random.RandomState(100 + num_players)
    decks = _decks(rng, G)
    js = init_j(jnp.asarray(decks))
    ts = tenv.init_from_deck(cfg, torch.as_tensor(decks))
    for turn in range(cfg.max_turns):
        _assert_state(js, ts, f"turn {turn}")
        jo, jm = obs_j(js)
        to, tm = tenv.observe(cfg, ts)
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        np.testing.assert_array_equal(np.asarray(rowpts_j(js.board, js.row_len)),
                                      tenv.row_points(cfg, ts.board, ts.row_len).numpy())
        hs = ts.hands_sorted.numpy()
        counts = (hs >= 0).sum(-1)
        picks = (rng.random_sample(counts.shape) * counts).astype(np.int64)
        actions = np.take_along_axis(hs, picks[..., None], -1)[..., 0].astype(np.int32)
        js, jr = step_j(js, jnp.asarray(actions))
        ts, tr = tenv.step(cfg, ts, torch.as_tensor(actions))
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy(), err_msg=f"rewards turn {turn}")
    _assert_state(js, ts, "final")
    assert tenv.is_done(ts).all()


@pytest.mark.parametrize("num_players", [2, 4, 6])
def test_resolve_turn_plain_matches_jax_step(num_players):
    """K1's twin alone: board, row_len and rewards equal the JAX step's."""
    jcfg, cfg = JaxConfig(num_players), EnvConfig(num_players)
    init_j, step_j, _, _ = _jax_fns(jcfg)
    rng = np.random.RandomState(7 * num_players)
    js = init_j(jnp.asarray(_decks(rng, 32)))
    for turn in range(cfg.max_turns):
        hs = np.asarray(js.hands_sorted)
        counts = (hs >= 0).sum(-1)
        picks = (rng.random_sample(counts.shape) * counts).astype(np.int64)
        actions = np.take_along_axis(hs, picks[..., None], -1)[..., 0].astype(np.int32)
        b, l, r = resolve_turn_plain(cfg, torch.tensor(np.asarray(js.board)),
                                     torch.tensor(np.asarray(js.row_len)), torch.as_tensor(actions))
        js, jr = step_j(js, jnp.asarray(actions))
        np.testing.assert_array_equal(np.asarray(js.board), b.numpy(), err_msg=f"turn {turn}")
        np.testing.assert_array_equal(np.asarray(js.row_len), l.numpy())
        np.testing.assert_array_equal(np.asarray(jr), r.numpy())


def test_resolve_turn_cpu_tensor_takes_plain_twin():
    cfg = EnvConfig(4)
    s = tenv.init_from_deck(cfg, torch.as_tensor(_decks(np.random.RandomState(3), 4)))
    acts = s.hands_sorted[:, :, 0].contiguous()
    for x, y in zip(resolve_turn(cfg, s.board, s.row_len, acts),
                    resolve_turn_plain(cfg, s.board, s.row_len, acts)):
        assert torch.equal(x, y)


def test_card_points_match_jax_table():
    np.testing.assert_array_equal(POINTS_104, JAX_POINTS)
    cards = torch.arange(-1, 104)
    np.testing.assert_array_equal(card_points_formula(cards).numpy(),
                                  np.asarray(jenv.card_points_formula(jnp.arange(-1, 104))))


def test_rules_undercut_and_sixth_card():
    """Hand-built boards: the sixth card captures the row; an undercut takes
    the cheapest row (first minimum on ties), as in test_engine_rules.py."""
    cfg = EnvConfig(2)
    board = torch.full((1, 4, 6), -1, dtype=torch.int32)
    board[0, 0, :5] = torch.tensor([10, 11, 12, 13, 14])
    board[0, 1, 0], board[0, 2, 0], board[0, 3, 0] = 30, 50, 54
    row_len = torch.tensor([[5, 1, 1, 1]], dtype=torch.int32)
    assert tenv.row_points(cfg, board, row_len)[0].tolist() == [10, 1, 1, 7]
    b, l, r = resolve_turn_plain(cfg, board, row_len, torch.tensor([[20, 2]], dtype=torch.int32))
    # Card 2 plays first and undercuts every row: rows 1 and 2 tie at 1 point,
    # the first (row 1) is captured.
    assert b[0, 1].tolist() == [2, -1, -1, -1, -1, -1] and int(l[0, 1]) == 1
    # Card 20 then lands on row 0 as its sixth card and captures its 10 points.
    assert b[0, 0].tolist() == [20, -1, -1, -1, -1, -1] and int(l[0, 0]) == 1
    assert r[0].tolist() == [-10, -1]
    assert b[0, 2, 0] == 50 and b[0, 3, 0] == 54
