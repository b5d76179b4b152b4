"""The port's device arena (``runtime/arena.py``) against the JAX package's.

The port of ``tests/test_arena.py`` (a mixed matchup, two-seat determinism and
a seed change, host-only agents rejected), then the port's ``play_match`` on
JAX's dealt state and JAX's draws (``torch_jax_noise.arena_noise``) against
JAX's ``play_match``, from converted weights: the scores are equal exactly.
"""

import jax
import numpy as np
import pytest
import torch

import rl6nimmt_tpu.agents as jag
from rl6nimmt_tpu.runtime.arena import play_match as jplay_match
from rl6nimmt_tpu.runtime.arena import seat_policy_of as jseat_policy_of
from rl6nimmt_torch import agents as tag
from rl6nimmt_torch.engine import EnvConfig
from rl6nimmt_torch.nets import params_from_jax
from rl6nimmt_torch.runtime import arena as tarena
from rl6nimmt_torch.runtime import play_match, seat_policy_of
from torch_jax_noise import arena_noise

CPU = dict(device="cpu")
HID = (16,)


def test_mixed_matchup_runs():
    agents = [tag.DrunkHamster(seed=0, **CPU), tag.BatchedReinforceAgent(seed=1, **CPU),
              tag.BatchedACERAgent(seed=2, **CPU), tag.Noisy_D3QN_PRB_NStep(seed=3, **CPU)]
    scores = play_match(agents, num_games=64, seed=0, device="cpu")
    assert scores.shape == (64, 4) and scores.dtype == np.int32
    assert (scores <= 0).all()
    # Every game hands out penalties somewhere.
    assert (scores.sum(axis=1) < 0).any()


def test_two_seat_matchup_and_determinism():
    agents = [tag.DrunkHamster(seed=0, **CPU), tag.BatchedReinforceAgent(seed=1, **CPU)]
    a = play_match(agents, num_games=32, seed=5, device="cpu")
    b = play_match(agents, num_games=32, seed=5, device="cpu")
    np.testing.assert_array_equal(a, b)
    c = play_match(agents, num_games=32, seed=6, device="cpu")
    assert not np.array_equal(a, c)


def test_host_only_agents_are_rejected():
    assert seat_policy_of(tag.MCSAgent(seed=0, **CPU)) is None
    assert seat_policy_of(tag.Human(device="cpu")) is None
    # JAX's rule: the masked variant is no BatchedReinforceAgent, so it has no seat policy.
    assert seat_policy_of(tag.MaskedReinforceAgent(seed=0, **CPU)) is None
    with pytest.raises(ValueError, match="not device-representable"):
        play_match([tag.DrunkHamster(seed=0, **CPU), tag.MCSAgent(seed=1, **CPU)], num_games=8, device="cpu")


def test_seat_policies_and_injected_noise():
    """Each kind's seat policy; a match replays from an injected noise, and a
    generator seeded alike draws one."""
    dqn = tag.DQNVanilla(seed=4, hidden_sizes=HID, **CPU)
    acer = tag.BatchedACERAgent(seed=2, hidden_sizes=HID, **CPU)
    assert seat_policy_of(tag.DrunkHamster(seed=0, **CPU)) == (tarena.SeatPolicy("random"), None)
    assert seat_policy_of(acer)[0] == tarena.SeatPolicy("policy", spec=acer.spec)
    assert seat_policy_of(dqn)[0] == tarena.SeatPolicy("dqn", spec=dqn.spec, dqn_cfg=dqn.cfg)
    cfg = EnvConfig(2)
    policies = (seat_policy_of(dqn)[0], seat_policy_of(acer)[0])
    gen = torch.Generator().manual_seed(3)
    noise = tarena.ArenaNoise(
        deal_seed=int(torch.randint(0, 2**62, (1,), generator=gen)),
        turns=[[tarena.draw_seat(p, gen, 16, cfg.hand_size) for p in policies] for _ in range(cfg.max_turns)])
    arena = tarena.make_arena(cfg, policies, 16, device="cpu")
    a = arena((dqn.params, acer.params), (0.5, 0.0), noise)
    b = arena((dqn.params, acer.params), (0.5, 0.0), torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (16, 2) and (a <= 0).all()
    with pytest.raises(TypeError, match="ArenaNoise"):
        arena((dqn.params, acer.params), (0.5, 0.0), 3)


def _pair(jagent, tcls, **kwargs):
    tagent = tcls(device="cpu", **kwargs)
    if getattr(jagent, "params", None) is not None:
        tagent.params = params_from_jax(jax.tree.map(np.asarray, jagent.params), "cpu")
    return tagent


LINEUPS = {
    # the mixed four seats: random, REINFORCE, ACER and the noisy flagship DQN
    "mixed": [("DrunkHamster", {}), ("BatchedReinforceAgent", {"hidden_sizes": HID}),
              ("BatchedACERAgent", {"hidden_sizes": HID}), ("Noisy_D3QN_PRB_NStep", {"hidden_sizes": HID})],
    # two seats: an epsilon-greedy dueling DQN (explores about half its moves) and ACER
    "two_seat": [("DuellingDQNAgent", {"hidden_sizes": HID}), ("BatchedACERAgent", {"hidden_sizes": HID})],
}


@pytest.mark.parametrize("lineup", sorted(LINEUPS))
def test_play_match_equals_jax_on_replayed_noise(lineup):
    jagents, tagents = [], []
    for i, (name, kw) in enumerate(LINEUPS[lineup]):
        jagent = getattr(jag, name)(seed=10 + i, **kw)
        tagent = _pair(jagent, getattr(tag, name), seed=10 + i, **kw)
        if isinstance(jagent, jag.DQNAgent) and not jagent.cfg.noisy:
            jagent.eps = tagent.eps = 0.5
        jagents.append(jagent)
        tagents.append(tagent)
    G, seed = 24, 7
    want = jplay_match(jagents, num_games=G, seed=seed)
    noise = arena_noise([jseat_policy_of(a)[0] for a in jagents], G, seed)
    got = play_match(tagents, num_games=G, device="cpu", noise=noise)
    np.testing.assert_array_equal(got, want)
    assert (got <= 0).all() and got.shape == (G, len(jagents))
