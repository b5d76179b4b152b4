"""The port's Tournament against the JAX package's on one ``np.random`` seed.

Both tournaments seat the same scripted agents (a stub that plays the card its
observation picks and draws nothing) and deal every game from the same decks
(both wrappers' ``reset`` patched to ``reset_with_deck``), so one global seed
gives both the same lineups and the same games.  They must then hold equal
records (scores, midrank positions, wins, ELO, baseline evaluations), make the
same ``evolve`` clones and culls under every metric, print the same table,
migrate legacy pickles alike -- and consume ``np.random`` identically, also
through ``play_device_block`` with device-routed random seats.
"""

import itertools
import pickle

import numpy as np
import pytest

import rl6nimmt_tpu.agents as jag
from rl6nimmt_tpu.engine.wrapper import SechsNimmtEnv as JEnv
from rl6nimmt_tpu.tournament import Tournament as JTournament
from rl6nimmt_torch import agents as tag
from rl6nimmt_torch.engine.wrapper import SechsNimmtEnv as TEnv
from rl6nimmt_torch.tournament import Tournament

DECKS = [np.random.RandomState(1000 + s).permutation(104) for s in range(64)]


class Stub:
    """A scripted seat: the legal card at (sum of its observation) mod the hand."""

    def __init__(self):
        self.learned = 0

    def __call__(self, state, legal_actions, **kwargs):
        return legal_actions[int(np.asarray(state, np.float64).sum()) % len(legal_actions)], {}

    def learn(self, **kwargs):
        self.learned += 1
        return 0.0


@pytest.fixture
def same_decks(monkeypatch):
    for cls in (JEnv, TEnv):
        counter = itertools.count()
        monkeypatch.setattr(cls, "reset", lambda self, c=counter: self.reset_with_deck(DECKS[next(c) % len(DECKS)]))


def _pair(**kwargs):
    baseline = kwargs.pop("baseline", False)
    j = JTournament(baseline_agents=[Stub()] if baseline else None, **kwargs)
    t = Tournament(baseline_agents=[Stub()] if baseline else None, device="cpu", **kwargs)
    for i in range(5):
        j.add_player(f"s{i}", Stub())
        t.add_player(f"s{i}", Stub())
    return j, t


FIELDS = ("descendant", "active", "played_games", "scores", "positions", "wins", "elos", "baseline_scores",
          "baseline_positions", "baseline_wins")


def assert_same(j, t):
    assert list(t.players) == list(j.players)
    assert t.total_games == j.total_games
    for name, rec in j.players.items():
        mine = t.players[name]
        assert mine.agent.__name__ == rec.agent.__name__ == name
        for f in FIELDS:
            a, b = getattr(mine, f), getattr(rec, f)
            if isinstance(b, list):
                np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0, atol=1e-9,
                                           err_msg=f"{name}.{f}")
            else:
                assert a == b, (name, f)
    assert str(t) == str(j)
    assert t.winner().__name__ == j.winner().__name__


def test_games_blocks_and_baselines_equal_jax(same_decks):
    j, t = _pair(min_players=2, max_players=4, baseline=True, baseline_condition=3, baseline_num_games=2)
    for tour in (j, t):
        np.random.seed(11)
        for _ in range(4):
            tour.play_game()
        tour.play_block(5)
        tour.play_device_block(3)       # stubs have no device decision: the host block driver
        tour.play_block(2, num_players=3)
        tour.state_after = np.random.get_state()[1].copy()
    np.testing.assert_array_equal(t.state_after, j.state_after)
    assert_same(j, t)
    assert any(r.baseline_scores for r in t.players.values())
    np.random.seed(12)
    lineups = [j._choose_players(None)[0] for _ in range(5)]
    np.random.seed(12)
    assert [t._choose_players(None)[0] for _ in range(5)] == lineups


@pytest.mark.parametrize("metric", ["elo", "tournament_scores", "tournament_positions", "tournament_wins"])
def test_evolve_equals_jax(same_decks, metric):
    j, t = _pair(min_players=2, max_players=3)
    for tour in (j, t):
        np.random.seed(21)
        tour.play_block(12)
        tour.evolve(copies=(2, 1), max_players=4, max_per_descendant=1, metric=metric)
        tour.play_block(6)
        tour.evolve(copies=(2,), max_players=6, max_per_descendant=2, metric=metric)
    assert_same(j, t)
    assert len(t.active_agents()) > 0 and any("_" in n for n in t.active_agents())
    clone = pickle.loads(pickle.dumps(t))
    assert_same(j, clone)


def test_legacy_pickle_migration_equals_jax():
    def legacy(cls):
        return {
            "min_players": 2, "max_players": 4, "baseline_agents": None, "baseline_num_games": 1,
            "baseline_condition": 10, "elo_initial": 1600, "elo_k": 32, "total_games": 3,
            "agents": {"a": cls(seed=0), "b": cls(seed=1)}, "descendants": {"a": "a", "b": "b"},
            "active": {"a": True, "b": False}, "played_games": {"a": 3, "b": 3},
            "tournament_scores": {"a": [-5, -7, -2], "b": [-9, -1, -4]},
            "tournament_positions": {"a": [1.0, 0.0, 1.0], "b": [0.0, 1.0, 0.0]},
            "tournament_wins": {"a": [1.0, 0.0, 1.0], "b": [0.0, 1.0, 0.0]},
            "baseline_scores": {"a": [], "b": []}, "baseline_positions": {"a": [], "b": []},
            "baseline_wins": {"a": [], "b": []},
            "elos": {"a": [1600, 1610, 1605, 1615], "b": [1600, 1590, 1595, 1585]},
        }

    j = JTournament.__new__(JTournament)
    j.__setstate__(legacy(jag.DrunkHamster))
    t = Tournament.__new__(Tournament)
    t.__setstate__(legacy(lambda seed: tag.DrunkHamster(seed=seed, device="cpu")))
    for tour in (j, t):
        for name, rec in tour.players.items():
            rec.agent.__name__ = name
    assert_same(j, t)
    assert t.active_agents() == ["a"] and t.elos["a"][-1] == 1615
    t2 = pickle.loads(pickle.dumps(t))
    assert t2.players["a"].elos == t.players["a"].elos and t2.device == t.device


def test_device_block_consumes_np_random_as_jax():
    """Random seats run as device blocks in both packages (the port draws its
    block generator's seed with JAX's one ``randint`` a dispatch), stub
    seats through the host block driver; the global generator ends in the
    same state, so the lineups drawn after the block are equal."""
    j = JTournament(min_players=2, max_players=2)
    t = Tournament(min_players=2, max_players=2, device="cpu")
    for i in range(3):
        j.add_player(f"r{i}", jag.DrunkHamster(seed=i))
        t.add_player(f"r{i}", tag.DrunkHamster(seed=i, device="cpu"))
    j.add_player("stub", Stub())
    t.add_player("stub", Stub())
    states = []
    for tour in (j, t):
        np.random.seed(31)
        tour.play_device_block(8, bucket=8)
        states.append(np.random.get_state()[1].copy())
        assert tour.total_games == 8
    np.testing.assert_array_equal(states[0], states[1])
    np.random.seed(32)
    after = [j._choose_players(None)[0] for _ in range(6)]
    np.random.seed(32)
    assert [t._choose_players(None)[0] for _ in range(6)] == after
    assert [r.played_games for r in t.players.values()] == [r.played_games for r in j.players.values()]


def test_clones_carry_agent_state():
    agent = tag.BatchedReinforceAgent(seed=5, device="cpu")
    agent.train()
    t = Tournament(device="cpu")
    t.add_player("r1", agent)
    t.copy_player("r1", "r2")
    from rl6nimmt_torch.agents.dqn import tree_leaves

    import torch

    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(t.agents["r1"].parameters()),
                                                  tree_leaves(t.agents["r2"].parameters())))
    assert t.agents["r2"].__name__ == "r2" and t.agents["r2"] is not t.agents["r1"]
    assert torch.equal(t.agents["r2"].generator.get_state(), t.agents["r1"].generator.get_state())
