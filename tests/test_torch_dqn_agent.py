"""The port's DQNAgent lattice and agent registry against the JAX package's.

Every one of the 12 ``DQN_VARIANTS`` is built in both packages with the JAX
agent's weights carried over (``nets.params_from_jax``):

* ``forward`` gives the same action on the same states, epsilon draws
  replayed through NumPy's global generator and the noisy nets' noise
  rebuilt from the key the JAX agent splits (``PARITY_TORCH.md`` section 14);
* ``learn`` over one transition stream, with the same minibatch indices (the
  same ``np.random`` state before each call) and the same learn noise, gives
  losses and, under SGD, parameters within float32 tolerance (under Adam the
  losses only, ``PARITY_TORCH.md`` section 13), and PER the same priorities.

The registry's 20 keys and method lists equal JAX's, and every key builds
and finishes a game.
"""

import re

import jax
import numpy as np
import optax
import pytest

import rl6nimmt_tpu.agents as jag
from rl6nimmt_tpu.agents import dqn as jdqn
from rl6nimmt_tpu.nets import draw_mlp_noise as jdraw_mlp_noise
from rl6nimmt_torch import agents as tag
from rl6nimmt_torch.agents.dqn import Sgd, tree_leaves
from rl6nimmt_torch.nets import noise_from_jax, params_from_jax
from rl6nimmt_torch.runtime.session import GameSession

KW = dict(hidden_sizes=(16,), minibatch=4, history_length=64)
RTOL, ATOL = 1e-5, 1e-6


def _leaves(tree):
    """A JAX tree's leaves in the port's order (trunk then heads, per layer its keys)."""
    return [x.numpy() for x in tree_leaves(params_from_jax(jax.tree.map(np.asarray, tree), "cpu"))]


def _pair(key):
    kw = dict(KW, n_steps=3) if "nstep" in key else dict(KW)
    j = jdqn.DQN_VARIANTS[key](seed=1, **kw)
    t = tag.DQN_VARIANTS[key](seed=1, device="cpu", **kw)
    t.params = params_from_jax(jax.tree.map(np.asarray, j.params), "cpu")
    if j.cfg.double:
        t.target_params = params_from_jax(jax.tree.map(np.asarray, j.target_params), "cpu")
    return j, t


def _next_key(agent):
    """The key the JAX agent's next ``next_key()`` returns."""
    return jax.random.split(agent._rng)[1]


def _stream(n, seed):
    rng = np.random.RandomState(seed)
    for i in range(n):
        yield dict(state=rng.randint(-1, 104, 47).astype(np.float32), reward=int(-rng.randint(0, 6)),
                   action=int(rng.randint(104)), next_state=rng.randint(-1, 104, 47).astype(np.float32),
                   next_reward=0, done=i % 10 == 9, episode_end=i % 10 == 9, num_episode=0)


@pytest.mark.parametrize("key", sorted(jdqn.DQN_VARIANTS))
def test_variant_forward_and_sgd_learn_equal_jax(key):
    j, t = _pair(key)
    assert t.cfg.__dict__ == j.cfg.__dict__ and type(t).__name__ == type(j).__name__
    for agent in (j, t):
        agent.train()
    assert t.eps == j.eps == 1.0
    j.eps = t.eps = 0.3
    rng = np.random.RandomState(2)
    for i in range(12):
        state = rng.randint(-1, 104, 47).astype(np.float32)
        legal = sorted(rng.choice(104, size=1 + i % 10, replace=False).tolist())
        if t.cfg.noisy:
            noise = noise_from_jax(jdraw_mlp_noise(j.spec, _next_key(j)), "cpu")
            t._act_noise = lambda noise=noise: noise
        np.random.seed(100 + i)
        ja, jinfo = j.forward(state, legal)
        np.random.seed(100 + i)
        ta, tinfo = t.forward(state, legal)
        assert ta == ja and tinfo.keys() == jinfo.keys()
        np.testing.assert_allclose(tinfo["value"], jinfo["value"], rtol=RTOL, atol=ATOL * max(1, abs(jinfo["value"])))

    lr = 1e-6   # raw observations (card ids up to 103): steps of 1e-5 diverge
    j.optimizer = optax.sgd(lr)
    j.opt_state = j.optimizer.init(j.params)
    j._learn_step = jdqn.make_learn_step(j.cfg, j.spec, j.optimizer, j.gamma)
    t.optimizer, t.opt_state = Sgd(lr), None
    t._rebuild()
    start = [x.clone() for x in tree_leaves(t.params)]
    learned = 0
    for i, step in enumerate(_stream(25, 3)):
        if t.cfg.noisy:
            ne, nt = jdqn.learn_noise(j.cfg, j.spec, _next_key(j))
            noise = (noise_from_jax(ne, "cpu"), tuple(noise_from_jax(n, "cpu") for n in nt))
            t._learn_noise = lambda noise=noise: noise
        np.random.seed(200 + i)
        jl = j.learn(**step)
        np.random.seed(200 + i)
        tl = t.learn(**step)
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(jl).max())))
        learned += bool(jl[0])
        assert t.eps == j.eps and t.step == j.step and len(t.history) == len(j.history)
    assert learned > 10
    assert max(float((a - b).abs().max()) for a, b in zip(tree_leaves(t.params), start)) > 1e-3
    for a, b in zip(tree_leaves(t.params), _leaves(j.params)):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(b).max())))
    if t.cfg.double:
        for a, b in zip(tree_leaves(t.target_params), _leaves(j.target_params)):
            np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(b).max())))
    if t.cfg.per:
        np.testing.assert_allclose(t.history.priorities, j.history.priorities, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("key", ["dqn", "noisy_d3qn_prb_nstep"])
def test_adam_losses_equal_jax(key):
    j, t = _pair(key)
    for agent in (j, t):
        agent.train()
    for i, step in enumerate(_stream(16, 4)):
        if t.cfg.noisy:
            ne, nt = jdqn.learn_noise(j.cfg, j.spec, _next_key(j))
            noise = (noise_from_jax(ne, "cpu"), tuple(noise_from_jax(n, "cpu") for n in nt))
            t._learn_noise = lambda noise=noise: noise
        np.random.seed(300 + i)
        jl = j.learn(**step)
        np.random.seed(300 + i)
        tl = t.learn(**step)
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(jl).max())))


def test_clone_keeps_state_and_rebuilds_the_learn_step():
    import pickle

    _, t = _pair("noisy_d3qn_prb_nstep")
    t.train()
    for step in _stream(12, 5):
        t.learn(**step)
    t.eps = 0.5
    c = pickle.loads(pickle.dumps(t))
    assert c._learn_step is not None and c.eps == 1.0        # JAX's unpickling re-enters train(True)
    assert c.opt_state.count == t.opt_state.count and len(c.history) == len(t.history)
    assert all((a == b).all() for a, b in zip(tree_leaves(c.params), tree_leaves(t.params)))
    assert c.learn(**next(_stream(1, 6)))[0] != 0.0


def test_registry_equals_jax():
    assert list(tag.AGENTS) == list(jag.AGENTS)
    assert {k: v.__name__ for k, v in tag.AGENTS.items()} == {k: v.__name__ for k, v in jag.AGENTS.items()}
    for name in ("POLICY_METHODS", "DDQN_METHODS", "NSTEP_METHODS", "NOISY_METHODS"):
        assert getattr(tag, name) == getattr(jag, name)
    assert set(jag.__all__) <= set(tag.__all__)
    assert list(tag.DQN_VARIANTS) == list(jdqn.DQN_VARIANTS)


@pytest.mark.parametrize("key", sorted(tag.AGENTS))
def test_every_key_builds_and_finishes_a_game(key, monkeypatch):
    cls = tag.AGENTS[key]
    kwargs = {"seed": 3, "device": "cpu"}
    if issubclass(cls, tag.BaseMCAgent):
        kwargs.update(mc_max=4, mc_per_card=1)
    if key == "human":
        monkeypatch.setattr("builtins.input", lambda prompt: re.search(r"cards: +(\d+)", prompt).group(1))
    agent = cls(**kwargs)
    agent.train()
    np.random.seed(4)
    session = GameSession(agent, tag.DrunkHamster(seed=5, device="cpu"), device="cpu")
    session.play_game()
    assert len(session.results) == 1 and (session.results[0] <= 0).all()
    np.testing.assert_array_equal(-session.results[0], session.env.scores)


def test_human_prompts_until_valid(monkeypatch):
    agent = tag.Human(name="Merle", device="cpu")
    feeds = iter(["notacard", "100", "8"])
    prompts = []
    monkeypatch.setattr("builtins.input", lambda p: (prompts.append(p), next(feeds))[1])
    action, info = agent.forward(state=None, legal_actions=[2, 7, 31])
    assert (action, info, len(prompts)) == (7, {}, 3)
    assert "Merle" in prompts[0] and "don't have that card" in prompts[2]
    assert agent.learn() == 0.0
