"""The port's SechsNimmtEnv and GameSession against the JAX package's.

On shared decks (``reset_with_deck``), on positions entered with
``reset_to`` and through whole games of scripted actions, both wrappers give
equal observations, legal lists, rewards, scores, boards, hands, done flags,
``render`` text and ``InvalidMoveException`` messages; a GameSession of
recording agents on one deck hands ``learn`` the same argument stream.
"""

import logging

import numpy as np
import pytest

from rl6nimmt_tpu.engine.env import InvalidMoveException as JInvalid
from rl6nimmt_tpu.engine.wrapper import SechsNimmtEnv as JEnv
from rl6nimmt_tpu.runtime.session import GameSession as JSession
from rl6nimmt_torch.engine import InvalidMoveException
from rl6nimmt_torch.engine.wrapper import SechsNimmtEnv
from rl6nimmt_torch.runtime.session import GameSession


def assert_view(a, b):
    (sa, la), (sb, lb) = a, b
    assert la == lb
    np.testing.assert_array_equal(np.stack(sa), np.stack(sb))


def _render(env, caplog):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        env.render()
    return [r.getMessage() for r in caplog.records]


@pytest.mark.parametrize("players,seed", [(2, 0), (4, 1), (6, 2), (10, 3)])
def test_games_on_shared_decks_equal_jax(players, seed, caplog):
    rng = np.random.RandomState(seed)
    deck = rng.permutation(104)
    names = [f"p{i}" for i in range(players)]
    j = JEnv(players, player_names=names, seed=0)
    t = SechsNimmtEnv(players, player_names=names, seed=0, device="cpu")
    assert_view(t.reset_with_deck(deck), j.reset_with_deck(deck))
    assert _render(t, caplog) == _render(j, caplog)
    done = False
    while not done:
        actions = [int(rng.choice(h)) for h in j.hands]
        jv, jr, jd, _ = j.step(actions)
        tv, tr, td, info = t.step(actions)
        assert_view(tv, jv)
        np.testing.assert_array_equal(tr, jr)
        assert td == jd and info == {}
        assert t.board == j.board and t.hands == j.hands and t.done == j.done
        np.testing.assert_array_equal(t.scores, j.scores)
        done = jd
    assert _render(t, caplog) == _render(j, caplog)
    assert any("The game is over!" in line for line in _render(t, caplog))
    assert (t.num_actions, t.state_length, t.reward_range) == (j.num_actions, j.state_length, j.reward_range)
    assert repr(t.action_space) == repr(j.action_space) and repr(t.observation_space) == repr(j.observation_space)


def test_reset_to_and_invalid_moves_equal_jax(caplog):
    board = [[3, 17], [40], [55, 60, 61, 70, 80], [99]]
    hands = [[0, 5, 54], [20, 41, 100], [1, 2, 101]]
    j, t = JEnv(3, seed=0), SechsNimmtEnv(3, seed=0, device="cpu")
    assert_view(t.reset_to(board, hands), j.reset_to(board, hands))
    assert _render(t, caplog) == _render(j, caplog)
    for bad in ([0, 20, 7], [0, 104, 1], [-1, 20, 1]):
        with pytest.raises(JInvalid) as je:
            j.step(bad)
        with pytest.raises(InvalidMoveException) as te:
            t.step(bad)
        assert str(te.value) == str(je.value)
    jv, jr, jd, _ = j.step([54, 41, 101])
    tv, tr, td, _ = t.step([54, 41, 101])
    assert_view(tv, jv)
    np.testing.assert_array_equal(tr, jr)
    assert t.board == j.board and td == jd
    with pytest.raises(AssertionError):
        t.step([0, 20])


def test_seeded_deals_repeat():
    a, b = SechsNimmtEnv(4, seed=5, device="cpu"), SechsNimmtEnv(4, seed=5, device="cpu")
    first = a.reset()
    assert_view(b.reset(), first)
    second = a.reset()
    assert second[1] != first[1]
    hands = sum(second[1], []) + [c for row in a.board for c in row]
    assert len(set(hands)) == 44 and all(len(h) == 10 for h in second[1])


class Recorder:
    """Plays the legal card its observation picks; records every learn call."""

    def __init__(self):
        self.calls = []

    def __call__(self, state, legal_actions, **kwargs):
        pick = int(np.asarray(state, np.float64).sum()) % len(legal_actions)
        return legal_actions[pick], {"pick": pick}

    def learn(self, **kwargs):
        self.calls.append(kwargs)


def test_session_learn_stream_equals_jax(monkeypatch):
    deck = np.random.RandomState(7).permutation(104)
    for cls in (JEnv, SechsNimmtEnv):
        monkeypatch.setattr(cls, "reset", lambda self: self.reset_with_deck(deck))
    jr, tr = [Recorder() for _ in range(3)], [Recorder() for _ in range(3)]
    js, ts = JSession(*jr, env_seed=1), GameSession(*tr, env_seed=1, device="cpu")
    for _ in range(2):
        js.play_game()
        ts.play_game()
    for a, b in zip(tr, jr):
        assert len(a.calls) == len(b.calls) == 20
        for x, y in zip(a.calls, b.calls):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=k)
    np.testing.assert_array_equal(np.stack(ts.results), np.stack(js.results))
    np.testing.assert_array_equal(-ts.results[-1], ts.env.scores)
    assert [c["num_episode"] for c in tr[0].calls] == [0] * 10 + [1] * 10
