"""The port's host block driver (``runtime/block.py``) against its session and JAX's block.

As ``tests/test_block.py`` holds the JAX package's: ``forward_many`` with one
request is the sequential ``forward``; a one-game block equals a
GameSession on the same deal (scores and a learner's parameters); the
tournament's ``play_block`` scores games like sequential play.  Against JAX:
on shared decks, random and scripted seats play the same block with the same
``np.random`` stream and end with equal scores.
"""

import itertools

import numpy as np
import pytest
import torch

import rl6nimmt_tpu.agents as jag
from rl6nimmt_tpu.engine.wrapper import SechsNimmtEnv as JEnv
from rl6nimmt_tpu.runtime.block import BlockSession as JBlockSession
from rl6nimmt_torch import agents as tag
from rl6nimmt_torch.agents.dqn import tree_leaves
from rl6nimmt_torch.engine.wrapper import SechsNimmtEnv
from rl6nimmt_torch.runtime.block import BlockSession
from rl6nimmt_torch.runtime.session import GameSession
from rl6nimmt_torch.tournament import Tournament


@pytest.mark.parametrize("make_agent", [
    lambda: tag.MCSAgent(mc_max=12, mc_per_card=2, seed=123, device="cpu"),
    lambda: tag.PUCTAgent(mc_max=12, mc_per_card=2, batch_playouts=4, hidden_sizes=(16,), seed=123, device="cpu"),
], ids=["mcs", "puct"])
def test_forward_many_single_request_matches_forward(make_agent):
    states, legal = SechsNimmtEnv(3, seed=11, device="cpu").reset()
    np.random.seed(77)
    a = make_agent()
    action_seq, info_seq = a.forward(states[0], legal[0])
    np.random.seed(77)
    b = make_agent()
    mem = b.new_memory()
    ((action_blk, info_blk),) = b.forward_many([states[0]], [legal[0]], [mem])
    assert action_blk == action_seq
    assert info_blk["log_prob"] == pytest.approx(info_seq["log_prob"])
    assert mem["available_cards"] == a.available_cards and mem["num_players"] == a.num_players


def test_block_of_one_game_equals_game_session():
    def agents():
        out = [tag.BatchedReinforceAgent(seed=5, device="cpu"), tag.DrunkHamster(seed=6, device="cpu")]
        for agent in out:
            agent.train()
        return out

    np.random.seed(99)
    seq = agents()
    session = GameSession(*seq, env_seed=42, device="cpu")
    session.play_game()
    np.random.seed(99)
    blk = agents()
    scores = BlockSession([blk], env_seeds=[42], device="cpu").play()
    np.testing.assert_array_equal(scores[0], session.results[0])
    for a, b in zip(tree_leaves(seq[0].params), tree_leaves(blk[0].params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mixed_search_games_share_an_agent():
    np.random.seed(3)
    mcs = tag.MCSAgent(mc_max=6, mc_per_card=1, seed=9, device="cpu")
    rnd1, rnd2 = tag.DrunkHamster(seed=1, device="cpu"), tag.DrunkHamster(seed=2, device="cpu")
    scores = BlockSession([[mcs, rnd1], [rnd2, mcs]], device="cpu").play()
    assert len(scores) == 2 and all(s.shape == (2,) and (s <= 0).all() for s in scores)


def test_play_block_scores_like_sequential_play():
    np.random.seed(13)
    t = Tournament(min_players=2, max_players=3, device="cpu")
    t.add_player("Random1", tag.DrunkHamster(seed=1, device="cpu"))
    t.add_player("Random2", tag.DrunkHamster(seed=2, device="cpu"))
    t.add_player("MCS", tag.MCSAgent(mc_max=6, mc_per_card=1, seed=3, device="cpu"))
    t.play_block(6)
    assert t.total_games == 6 and sum(t.played_games.values()) >= 12
    for name in t.agents:
        assert len(t.elos[name]) == t.played_games[name] + 1


class Stub:
    def __call__(self, state, legal_actions, **kwargs):
        return legal_actions[int(np.asarray(state, np.float64).sum()) % len(legal_actions)], {}

    def learn(self, **kwargs):
        return 0.0


def test_block_on_shared_decks_equals_jax(monkeypatch):
    decks = [np.random.RandomState(s).permutation(104) for s in range(8)]
    for cls in (JEnv, SechsNimmtEnv):
        counter = itertools.count()
        monkeypatch.setattr(cls, "reset", lambda self, c=counter: self.reset_with_deck(decks[next(c)]))
    shape = [(0, 1, 2), (2, 0), (1, 2, 0, 1), (0, 2)]
    jseats = [jag.DrunkHamster(seed=0), jag.DrunkHamster(seed=1), Stub()]
    tseats = [tag.DrunkHamster(seed=0, device="cpu"), tag.DrunkHamster(seed=1, device="cpu"), Stub()]
    np.random.seed(8)
    jscores = JBlockSession([[jseats[i] for i in g] for g in shape]).play()
    jstate = np.random.get_state()[1].copy()
    np.random.seed(8)
    tscores = BlockSession([[tseats[i] for i in g] for g in shape], device="cpu").play()
    np.testing.assert_array_equal(np.random.get_state()[1], jstate)
    for a, b in zip(tscores, jscores):
        np.testing.assert_array_equal(a, b)
