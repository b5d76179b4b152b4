"""Device-side learner updates (``runtime/device_learn.py``) against the host replay.

The port of ``tests/test_device_learn.py`` at its sizes: ``DeviceBlockSession(
device_learning=True)`` must give the parameter trajectory of the port's own
host ``learn`` replay on the same captured stream.  Ring-buffer DQN and both
REINFORCE variants are bit-exact (params, opt state, buffer size); PER agrees
within its float32 priority bookkeeping; ACER on its first train event and
over a block; the device buffer survives pickling and ``clone``.  Then one
captured event stream, from one converted set of params, goes through JAX's
planners and the port's, and the parameters agree within ``PARITY_TORCH.md``
section 7.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

import rl6nimmt_tpu.agents as jag
import rl6nimmt_tpu.runtime.device_learn as jdl
from rl6nimmt_torch import agents as tag
from rl6nimmt_torch.agents.dqn import tree_leaves
from rl6nimmt_torch.nets import adam_state_from_jax, params_from_jax, params_to_numpy
from rl6nimmt_torch.runtime import device_learn as tdl
from rl6nimmt_torch.runtime.device_tournament import DeviceBlockSession

HID = (16,)


def _leaves(tree):
    """Params or an Adam state as a flat list of numpy arrays (count first)."""
    if isinstance(tree, tag.AdamState):
        return [np.asarray(tree.count)] + _leaves(tree.mu) + _leaves(tree.nu)
    return [x.detach().cpu().numpy() for x in tree_leaves(tree)]


def tree_equal(a, b, what):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        np.testing.assert_array_equal(x, y, err_msg=what)


def _population(kind):
    """Fresh, seeded training agents on the CPU (the JAX test's lineups)."""
    cpu = dict(device="cpu")
    if kind == "ring":
        learners = [tag.DQNVanilla(seed=11, minibatch=8, hidden_sizes=HID, **cpu),
                    tag.BatchedReinforceAgent(seed=12, hidden_sizes=HID, **cpu),
                    tag.DrunkHamster(seed=14, **cpu)]
    elif kind == "masked":
        learners = [tag.MaskedReinforceAgent(seed=21, hidden_sizes=HID, **cpu),
                    tag.DrunkHamster(seed=22, **cpu),
                    tag.BatchedReinforceAgent(seed=23, hidden_sizes=HID, **cpu)]
    elif kind == "acer":
        learners = [tag.BatchedACERAgent(seed=13, hidden_sizes=HID, warmup=2, minibatch=3, **cpu),
                    tag.DrunkHamster(seed=15, **cpu), tag.DrunkHamster(seed=16, **cpu)]
    else:  # per
        learners = [tag.DQN_PRBAgent(seed=31, minibatch=8, history_length=64, hidden_sizes=HID, **cpu),
                    tag.Noisy_D3QN_PRB_NStep(seed=32, minibatch=8, n_steps=3, history_length=64,
                                             hidden_sizes=HID, **cpu),
                    tag.DrunkHamster(seed=33, **cpu)]
    for a in learners:
        if not isinstance(a, tag.DrunkHamster):
            a.train()
    return learners


def _run_blocks(kind, device_learning, n_games=6, n_blocks=2, seed=77):
    agents = _population(kind)
    np.random.seed(seed)
    trajectories = []
    for _ in range(n_blocks):
        DeviceBlockSession([list(agents)] * n_games, device_learning=device_learning, device="cpu").play()
        trajectories.append([{k: v.clone() for k, v in enumerate(tree_leaves(a.params))}
                             if a.parameters() is not None else None for a in agents])
    return agents, trajectories


def _traj_equal(h, d, what, **tol):
    for i in h:
        if tol:
            np.testing.assert_allclose(d[i].numpy(), h[i].numpy(), err_msg=what, **tol)
        else:
            np.testing.assert_array_equal(d[i].numpy(), h[i].numpy(), err_msg=what)


@pytest.mark.parametrize("kind", ["ring", "masked"])
def test_device_learning_matches_host_replay_bitexact(kind):
    host_agents, host_traj = _run_blocks(kind, device_learning=False)
    dev_agents, dev_traj = _run_blocks(kind, device_learning=True)
    for block in range(len(host_traj)):
        for i, (h, d) in enumerate(zip(host_traj[block], dev_traj[block])):
            if h is not None:
                _traj_equal(h, d, f"{kind}: agent {i} params diverged at block {block}")
    moved = 0
    for h, d in zip(host_agents, dev_agents):
        if h.parameters() is None:
            continue
        assert h.opt_state.count == d.opt_state.count > 0
        moved += 1
        tree_equal(h.opt_state, d.opt_state, "opt state diverged")
        if isinstance(h, tag.DQNAgent):
            assert len(h.history) == d._device_replay["size"] == 2 * 6 * 10
            assert (h.step, h.eps) == (d.step, d.eps)
    assert moved == 2


def test_device_learning_matches_host_replay_acer():
    """ACER: the same stream and update math; its first train event agrees to
    round-off and the whole block stays close (Adam normalizes the round-off
    of each later step up, as in the JAX test)."""
    _, host_traj = _run_blocks("acer", device_learning=False, n_games=4, n_blocks=1)
    _, dev_traj = _run_blocks("acer", device_learning=True, n_games=4, n_blocks=1)
    _traj_equal(host_traj[0][0], dev_traj[0][0], "acer first train event", rtol=1e-6, atol=1e-8)
    host_agents, host_traj = _run_blocks("acer", device_learning=False, n_blocks=1)
    dev_agents, dev_traj = _run_blocks("acer", device_learning=True, n_blocks=1)
    _traj_equal(host_traj[0][0], dev_traj[0][0], "acer block trajectory", rtol=2e-2, atol=1e-4)
    # One flush a game; past max(warmup 2, minibatch 3) flushes each trains twice.
    assert host_agents[0].opt_state.count == dev_agents[0].opt_state.count == 2 * (6 - 3)
    assert dev_agents[0]._device_replay["size"] == len(host_agents[0].history) == 6


def test_device_learning_matches_host_replay_per():
    """PER: the same trajectory up to the float32 priorities and cumulative sum
    against the host's float64 sum tree."""
    host_agents, host_traj = _run_blocks("per", device_learning=False)
    dev_agents, dev_traj = _run_blocks("per", device_learning=True)
    for block in range(len(host_traj)):
        for i, (h, d) in enumerate(zip(host_traj[block], dev_traj[block])):
            if h is not None:
                _traj_equal(h, d, f"per: agent {i} params diverged at block {block}", rtol=1e-4, atol=1e-6)
    for h, d in zip(host_agents[:2], dev_agents[:2]):
        assert len(h.history) == d._device_replay["size"] == 64   # the ring wrapped
        np.testing.assert_allclose(d._device_replay["pri"].numpy(), h.history.priorities, rtol=1e-4, atol=1e-6)
        assert d._device_replay["beta"] == pytest.approx(h.history.beta)


def test_device_learning_persists_across_sessions_and_clone():
    """The device buffer (storage, priorities, beta) pickles with the agent, so
    evolve's clones keep a device-learned agent's experience."""
    agents = _population("ring")
    np.random.seed(5)
    DeviceBlockSession([list(agents)] * 4, device_learning=True, device="cpu").play()
    dqn = agents[0]
    assert dqn._device_replay is not None and dqn._device_replay["size"] == 40
    clone = dqn.clone()
    assert clone._device_replay["size"] == 40 and clone._device_replay["ptr"] == 40
    tree_equal(clone.params, dqn.params, "clone params")
    for k, v in dqn._device_replay["storage"].items():
        assert torch.equal(clone._device_replay["storage"][k], v), k
    # A second block continues the clone's buffer.
    np.random.seed(6)
    DeviceBlockSession([[clone, agents[1], agents[2]]] * 2, device_learning=True, device="cpu").play()
    assert clone._device_replay["size"] == 60 and pickle.loads(pickle.dumps(clone))._device_replay["size"] == 60


def test_host_history_migrates_into_the_device_buffer():
    """A learner that learned on the host first keeps its experience: the host
    ring (a full PER ring from its pointer on, with priorities and beta) moves
    into the device buffer, and the next block continues from it."""
    agents = _population("per")
    np.random.seed(8)
    DeviceBlockSession([list(agents)] * 8, device="cpu").play()   # 80 stores into a ring of 64
    per = agents[0]
    order = [(per.history._ptr + i) % 64 for i in range(64)]
    tdl.DQNPlanner(per)
    st = per._device_replay
    assert (st["ptr"], st["size"], st["beta"]) == (0, 64, per.history.beta)
    np.testing.assert_array_equal(st["pri"].numpy(), per.history.priorities[order])
    np.testing.assert_array_equal(st["storage"]["state"].numpy(),
                                  np.stack([per.history._records[i]["state"] for i in order]))
    np.random.seed(9)
    DeviceBlockSession([list(agents)] * 2, device_learning=True, device="cpu").play()
    assert per._device_replay["size"] == 64 and per._device_replay["ptr"] == 20


def test_make_planner_routes_and_refuses():
    cpu = dict(device="cpu")
    assert isinstance(tdl.make_planner(tag.DQNVanilla(seed=0, hidden_sizes=HID, **cpu)), tdl.DQNPlanner)
    assert isinstance(tdl.make_planner(tag.BatchedACERAgent(seed=0, hidden_sizes=HID, **cpu)), tdl.ACERPlanner)
    assert tdl.make_planner(tag.MaskedReinforceAgent(seed=0, hidden_sizes=HID, **cpu)).masked
    assert not tdl.make_planner(tag.BatchedReinforceAgent(seed=0, hidden_sizes=HID, **cpu)).masked
    assert tdl.make_planner(tag.DQNVanilla(seed=0, hidden_sizes=HID, summary_writer=object(), **cpu)) is None
    with pytest.raises(TypeError, match="no device learner"):
        tdl.make_planner(tag.DrunkHamster(seed=0, **cpu))
    assert tdl.DEVICE_LEARN_FAMILIES == jdl.DEVICE_LEARN_FAMILIES
    assert (tdl.EV_NOOP, tdl.EV_STORE, tdl.EV_LEARN) == (jdl.EV_NOOP, jdl.EV_STORE, jdl.EV_LEARN)
    assert (tdl.DEFAULT_DEVICE_CAPACITY, tdl.DEFAULT_SEQ_CAPACITY) == (jdl.DEFAULT_DEVICE_CAPACITY,
                                                                        jdl.DEFAULT_SEQ_CAPACITY)


# ------------------------------------------------- the JAX planners, one stream


def _stream(n_games, seed):
    """A captured block stream for one seat: per step an observation, the padded
    hand, the chosen slot, its card, the lagged reward, done."""
    rng = np.random.RandomState(seed)
    steps = []
    for _ in range(n_games):
        deck = rng.permutation(104)[:10]
        for t in range(10):
            hand = np.full(10, -1, np.int32)
            hand[:10 - t] = np.sort(deck[t:])
            pick = int(rng.randint(10 - t))
            steps.append({"state": rng.uniform(-1, 104, 47).astype(np.float32), "hand": hand, "pick": pick,
                          "action": int(hand[pick]), "reward": -int(rng.randint(0, 4)) * int(rng.rand() < 0.3),
                          "done": t == 9})
    return steps


def _feed(planner, family, steps):
    for s, nxt in zip(steps, steps[1:] + [None]):
        if family == "dqn":
            planner.on_step(state=s["state"], reward=s["reward"], action=s["action"],
                            next_state=s["state"] if s["done"] else nxt["state"], done=s["done"])
        else:
            planner.on_step(step_record={"state": s["state"], "legal_cards": s["hand"],
                                         "chosen": np.int32(s["pick"])},
                            reward=s["reward"], episode_end=s["done"])


def _section7_close(got, want, what):
    """``PARITY_TORCH.md`` section 7: rtol 1e-5 and atol 1e-6 times the tensor's
    largest magnitude (at least 1)."""
    for x, y in zip(got, want, strict=True):
        scale = max(1.0, float(np.abs(y).max()))
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6 * scale, err_msg=what)


# Adam's eps at 1: with optax's default 1e-8 the first Adam step moves a
# parameter by ~lr whatever its gradient's size, so a gradient that is zero by
# construction (the policy head's bias: the softmax is shift-invariant) steps
# by the sign of each side's round-off (PARITY_TORCH.md section 13), and every
# small gradient amplifies its round-off likewise.  With eps above the
# gradients the update is close to linear in them, so round-off stays
# round-off and the params after the stream are held to section 7.
OPTIM = {"eps": 1.0}


@pytest.mark.parametrize("name,family", [("DQNVanilla", "dqn"), ("BatchedReinforceAgent", "rai"),
                                         ("DQN_PRBAgent", "dqn")])
def test_planner_stream_matches_jax(name, family):
    kw = dict(hidden_sizes=HID, optim_kwargs=OPTIM)
    if family == "dqn":
        kw.update(minibatch=8)
    if name == "DQN_PRBAgent":
        kw.update(history_length=32)
    jagent = getattr(jag, name)(seed=3, **kw)
    jagent.train()
    tagent = getattr(tag, name)(seed=3, device="cpu", **kw)
    tagent.train()
    tagent.params = params_from_jax(jax.tree.map(np.asarray, jagent.params), "cpu")
    tagent.opt_state = adam_state_from_jax(jax.tree.map(np.asarray, jagent.opt_state), "cpu")
    if family == "dqn" and jagent.cfg.double:
        tagent.target_params = params_from_jax(jax.tree.map(np.asarray, jagent.target_params), "cpu")
    steps = _stream(6, seed=4)
    np.random.seed(12)
    jplanner = jdl.make_planner(jagent)
    _feed(jplanner, family, steps)
    jplanner.execute()
    jstate = np.random.get_state()[1].copy()
    np.random.seed(12)
    tplanner = tdl.make_planner(tagent)
    _feed(tplanner, family, steps)
    tplanner.execute()
    np.testing.assert_array_equal(np.random.get_state()[1], jstate)   # the same np.random draws
    jp = [np.asarray(x) for x in jax.tree.leaves(jagent.params)]
    tp = jax.tree.leaves(params_to_numpy(tagent.params))   # JAX's leaf order
    assert tagent.opt_state.count == int(jax.tree.leaves(jagent.opt_state)[0]) > 0
    _section7_close(tp, jp, f"{name}: params after the stream")
    if family == "dqn":
        jst, tst = jagent._device_replay, tagent._device_replay
        assert (tst["ptr"], tst["size"]) == (int(jst["ptr"]), int(jst["size"]))
        for k, v in tst["storage"].items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jst["storage"][k]), err_msg=k)
        if tagent.cfg.per:
            np.testing.assert_allclose(tst["pri"].numpy(), np.asarray(jst["pri"]), rtol=1e-4, atol=1e-6)
            assert tst["beta"] == pytest.approx(jst["beta"])
