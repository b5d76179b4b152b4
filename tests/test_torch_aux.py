"""The port's host extras against the JAX package: parameter files (npz both
ways, the ``torch.save`` pair), ``iter_flatten``, ``sorted_hands``, the
recorded-seed parity harness and ``ParityEnv``, the CNN, the
independent-noise noisy layer, the metrics utilities and the
``train_selfplay`` twin (port of ``tests/test_aux.py``).

Float comparisons use ``PARITY_TORCH.md`` section 7's tolerance (rtol 1e-5,
atol 1e-6 times the largest magnitude); everything else is exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl6nimmt_tpu import nets as jnets
from rl6nimmt_tpu import parity as jparity
from rl6nimmt_tpu import utils as jutils
from rl6nimmt_tpu.engine import EnvConfig as JaxConfig
from rl6nimmt_tpu.engine import sorted_hands as jax_sorted_hands
from rl6nimmt_torch import nets, parity, utils
from rl6nimmt_torch.agents import BatchedReinforceAgent, DrunkHamster, Noisy_D3QN_PRB_NStep
from rl6nimmt_torch.agents.dqn import tree_leaves
from rl6nimmt_torch.engine import EnvConfig, SechsNimmtEnv, sorted_hands
from rl6nimmt_torch.runtime import GameSession
from rl6nimmt_torch.runtime.metrics import (MetricLogger, Timer, device_time, grad_stats, plot_grad_flow, timeit,
                                            trace)
from rl6nimmt_torch.tournament import Tournament

RTOL, ATOL = 1e-5, 1e-6


def assert_f32_close(actual, desired, err_msg=""):
    desired = np.asarray(desired)
    scale = max(1.0, float(np.abs(desired).max()))
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=RTOL, atol=ATOL * scale, err_msg=err_msg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_params(seed=0):
    spec = nets.MLPSpec(input_size=8, hidden_sizes=(4,), head_sizes=(2, 3), noisy=True)
    return nets.mlp_init(torch.Generator().manual_seed(seed), spec, "cpu")


# ---------------------------------------------------------- checkpoints


def test_checkpoint_roundtrip_tournament(tmp_path):
    t = Tournament(device="cpu")
    agent = BatchedReinforceAgent(seed=0, device="cpu")
    agent.train()
    t.add_player("r", agent)
    t.add_player("x", DrunkHamster(seed=1, device="cpu"))
    np.random.seed(0)
    t.play_game()
    path = str(tmp_path / "ckpt.pickle")
    utils.save_checkpoint(path, t)
    t2 = utils.load_checkpoint(path)
    assert t2.total_games == 1 and set(t2.agents) == {"r", "x"}
    for a, b in zip(tree_leaves(t.agents["r"].parameters()), tree_leaves(t2.agents["r"].parameters())):
        assert torch.equal(a, b)
    t2.play_game()
    assert t2.total_games == 2


def test_params_npz_roundtrip(tmp_path):
    params = _port_params()
    path = str(tmp_path / "params.npz")
    utils.save_params(path, params)
    like = nets.mlp_init(torch.Generator().manual_seed(1), nets.MLPSpec(8, (4,), (2, 3), noisy=True), "cpu")
    loaded = utils.load_params(path, like)
    for a, b in zip(tree_leaves(params), tree_leaves(loaded)):
        assert torch.equal(a, b)


def test_npz_files_cross_between_the_packages(tmp_path):
    """An npz the JAX package saved loads into the port (directly and through
    ``nets.convert``) and one the port saved loads into JAX: same key names."""
    jspec = jnets.MLPSpec(input_size=8, hidden_sizes=(4,), head_sizes=(2, 3), noisy=True)
    jparams = jnets.mlp_init(jax.random.key(7), jspec)
    path = str(tmp_path / "jax.npz")
    jutils.save_params(path, jparams)
    like = _port_params()
    direct = utils.load_params(path, like)
    via_convert = nets.params_from_jax(jutils.load_params(path, _np(jparams)), "cpu")
    want = nets.params_from_jax(_np(jparams), "cpu")
    for part in ("trunk", "heads"):
        for d, v, w in zip(direct[part], via_convert[part], want[part]):
            for k in w:
                assert torch.equal(d[k], w[k]) and torch.equal(v[k], w[k]), (part, k)
    back = str(tmp_path / "port.npz")
    utils.save_params(back, like)
    for a, b in zip(jax.tree.leaves(jutils.load_params(back, _np(jparams))),
                    jax.tree.leaves(nets.params_to_numpy(like))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_load_params_checks_shapes(tmp_path):
    path = str(tmp_path / "p.npz")
    utils.save_params(path, _port_params())
    wrong = nets.mlp_init(torch.Generator().manual_seed(0), nets.MLPSpec(8, (5,), (2, 3), noisy=True), "cpu")
    with pytest.raises(ValueError, match="shape"):
        utils.load_params(path, wrong)


def test_params_torch_save_roundtrip(tmp_path):
    """The Orbax pair on ``torch.save``: a checkpoint directory, overwritable."""
    params = _port_params()
    path = str(tmp_path / "orbax_ckpt")
    utils.save_params_orbax(path, params)
    like = {k: [{n: torch.zeros_like(v) for n, v in layer.items()} for layer in params[k]] for k in params}
    loaded = utils.load_params_orbax(path, like)
    for a, b in zip(tree_leaves(params), tree_leaves(loaded)):
        assert torch.equal(a, b)
    utils.save_params_orbax(path, loaded)
    for a, b in zip(tree_leaves(params), tree_leaves(utils.load_params_orbax(path, like))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nested,depth", [
    ([1, [2, (3, [4, 5])], np.array([6, 7]), "ab"], None),
    ([[1, [2, 3]], [4]], 1),
    ([[1, [2, [3, [4]]]], (5,)], 2),
    ([np.arange(4).reshape(2, 2), [[]], ()], None),
])
def test_iter_flatten_matches_jax(nested, depth):
    assert list(utils.iter_flatten(nested, max_depth=depth)) == list(jutils.iter_flatten(nested, max_depth=depth))


# --------------------------------------------------------------- engine


@pytest.mark.parametrize("players", [2, 4, 10])
def test_sorted_hands_matches_jax(players):
    cfg, jcfg = EnvConfig(players), JaxConfig(players)
    rng = np.random.RandomState(players)
    games = []
    for _ in range(16):
        hands = np.zeros((players, 104), bool)
        deck = rng.permutation(104)
        for p in range(players):
            held = rng.randint(0, 11)       # partial hands, as mid-game
            hands[p, deck[p * 10: p * 10 + held]] = True
        games.append(hands)
    port = sorted_hands(cfg, torch.as_tensor(np.stack(games)))
    for g, hands in enumerate(games):
        np.testing.assert_array_equal(port[g].numpy(), np.asarray(jax_sorted_hands(jcfg, jnp.asarray(hands))))


# --------------------------------------------------------------- parity


@pytest.mark.parametrize("seed,skip", [(1234, 0), (7, 3), (None, 0)])
def test_reference_deck_matches_jax(seed, skip):
    if seed is None:
        port = parity.reference_deck(rng=np.random.RandomState(99))
        ref = jparity.reference_deck(rng=np.random.RandomState(99))
    else:
        port, ref = parity.reference_deck(seed, skip_deals=skip), jparity.reference_deck(seed, skip_deals=skip)
    np.testing.assert_array_equal(port, ref)
    stream, jstream = parity.reference_deck_stream(5), jparity.reference_deck_stream(5)
    for _ in range(3):
        np.testing.assert_array_equal(next(stream), next(jstream))


def test_reference_deck_replays_numpy_shuffle():
    np.random.seed(1234)
    expected = np.arange(104)
    np.random.shuffle(expected)
    np.testing.assert_array_equal(parity.reference_deck(1234), expected)
    hands, board = parity.reference_hands_and_board(expected, num_players=4)
    assert (hands, board) == jparity.reference_hands_and_board(expected, num_players=4)
    env = parity.ParityEnv(num_players=4)
    env.reset_with_deck(expected)
    assert env.hands == hands and env.board == board
    wrapper = SechsNimmtEnv(4, device="cpu")
    wrapper.reset_with_deck(expected)
    assert wrapper.hands == hands and wrapper.board == board


@pytest.mark.parametrize("players,summaries", [(2, True), (4, True), (6, False)])
def test_parity_env_matches_jax_on_the_same_decks(players, summaries):
    rng = np.random.RandomState(players)
    for game in range(3):
        deck = parity.reference_deck(100 * players + game)
        port = parity.ParityEnv(num_players=players, include_summaries=summaries)
        ref = jparity.ParityEnv(num_players=players, include_summaries=summaries)
        (ps, pl), (rs, rl) = port.reset_with_deck(deck), ref.reset_with_deck(deck)
        done = False
        while not done:
            assert pl == rl
            for a, b in zip(ps, rs):
                np.testing.assert_array_equal(a, b)
            actions = [int(rng.choice(h)) for h in pl]
            (ps, pl), pr, done, _ = port.step(actions)
            (rs, rl), rr, rdone, _ = ref.step(actions)
            np.testing.assert_array_equal(pr, rr)
            assert done == rdone
        np.testing.assert_array_equal(port.scores, ref.scores)
        assert port.state_length == ref.state_length
    with pytest.raises(parity.IllegalMoveError):
        port.reset_with_deck(deck)
        port.step([int(port.hands[1][0])] * players)


# ------------------------------------------------------------------ nets


@pytest.mark.parametrize("activation,hw,channels", [("relu", (16, 16), (8,)), ("tanh", (12, 8), (4, 6)),
                                                    ("gelu", (9, 13), ())])
def test_cnn_apply_matches_jax(activation, hw, channels):
    jspec = jnets.CNNSpec(in_channels=3, hidden_channels=channels, out_channels=4, activation=activation)
    spec = nets.CNNSpec(in_channels=3, hidden_channels=channels, out_channels=4, activation=activation)
    jparams = jnets.cnn_init(jax.random.key(5), jspec)
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jnets.cnn_apply(jspec, jparams, jnp.asarray(x)))
    got = nets.cnn_apply(spec, nets.cnn_params_from_jax(_np(jparams), "cpu"), torch.as_tensor(x))
    assert got.shape == want.shape
    assert_f32_close(got.numpy(), want)
    assert spec.linear_out_size(*hw) == jspec.linear_out_size(*hw)


def test_cnn_shapes():
    spec = nets.CNNSpec(in_channels=3, hidden_channels=(8,), out_channels=4)
    params = nets.cnn_init(torch.Generator().manual_seed(5), spec, "cpu")
    assert [tuple(l["w"].shape) for l in params] == [(3, 3, 3, 8), (3, 3, 8, 4)]
    assert max(float(l["w"].abs().max()) for l in params) <= 1.0 / np.sqrt(3 * 9)
    y = nets.cnn_apply(spec, params, torch.ones((2, 16, 16, 3)))
    assert y.shape == (2, 4, 4, 4)  # two 2x2 pools: 16 -> 8 -> 4
    # The reference's off-by-one (one pool too many), kept.
    assert spec.linear_out_size(16, 16) == 2 * 2 * 4


def test_independent_noisy_linear_matches_jax():
    """factorized=False: sigma_init itself, weights uniform in sqrt(3/in), and
    the forward on independent standard-normal noise (JAX's draws injected)."""
    key = jax.random.key(11)
    jparams = jnets.noisy_linear_init(key, 6, 5, sigma_init=0.017, factorized=False)
    x = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    apply_key = jax.random.key(12)
    want = np.asarray(jnets.noisy_linear_apply(jparams, jnp.asarray(x), apply_key, factorized=False))
    kw, kb = jax.random.split(apply_key)
    noise = {"w": torch.as_tensor(np.array(jax.random.normal(kw, (6, 5)))),
             "b": torch.as_tensor(np.array(jax.random.normal(kb, (5,))))}
    params = {k: torch.as_tensor(np.array(v)) for k, v in jparams.items()}
    got = nets.noisy_linear_apply(params, torch.as_tensor(x), noise, factorized=False)
    assert_f32_close(got.numpy(), want)
    np.testing.assert_array_equal(nets.noisy_linear_apply(params, torch.as_tensor(x)).numpy(),
                                  np.asarray(jnets.noisy_linear_apply(jparams, jnp.asarray(x), None)))
    own = nets.noisy_linear_init(torch.Generator().manual_seed(0), 6, 5, sigma_init=0.017, device="cpu",
                                 factorized=False)
    assert torch.all(own["sigma_w"] == 0.017) and torch.all(own["sigma_b"] == 0.017)
    assert float(own["w"].abs().max()) <= np.sqrt(3 / 6) and float(own["b"].abs().max()) <= np.sqrt(3 / 6)


# --------------------------------------------------------------- metrics


def test_timer_and_timeit_and_gradstats():
    timer = Timer()
    with timer.measure("block", block_on=torch.ones(2)):
        _ = sum(range(1000))
    assert timer.summary()["block"]["count"] == 1

    @timeit
    def f(x):
        return x + 1

    assert f(1) == 2
    grads = {"layer": {"w": torch.ones((2, 2)), "b": torch.zeros(2)}}
    stats = grad_stats(grads)
    assert stats["layer/w"]["mean_abs"] == 1.0 and stats["layer/b"]["max_abs"] == 0.0
    assert stats == _jax_grad_stats(grads)
    assert device_time(lambda a: a * 2, torch.ones(8), iters=3) > 0


def _jax_grad_stats(grads):
    from rl6nimmt_tpu.runtime.metrics import grad_stats as jax_grad_stats

    return jax_grad_stats(jax.tree.map(lambda t: jnp.asarray(t.numpy()), grads))


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.ones(64).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_dqn_agent_with_metric_logger(tmp_path):
    log_path = str(tmp_path / "metrics.jsonl")
    logger = MetricLogger(log_path)
    agent = Noisy_D3QN_PRB_NStep(seed=2, minibatch=8, history_length=500, summary_writer=logger, device="cpu")
    agent.train()
    GameSession(agent, DrunkHamster(seed=3, device="cpu"), device="cpu").play_game()
    logger.close()
    assert os.path.exists(log_path)
    # The reference's TensorBoard scalars: debug/eps at every episode end and
    # debug/bellman_target every 10th episode once the buffer is warm (game 0 here).
    assert logger.series["debug/eps"]
    assert logger.series["debug/bellman_target"]


def test_plot_grad_flow_writes_figure(tmp_path):
    pytest.importorskip("matplotlib")
    grads = {
        "trunk": [{"w": torch.full((4, 3), 0.01), "b": torch.ones(3),
                   "sigma_w": torch.full((4, 3), 0.002), "sigma_b": torch.ones(3)}],
        "heads": [{"w": torch.full((3, 2), 0.005), "b": torch.ones(2)}],
    }
    out = tmp_path / "gf.png"
    plot_grad_flow(grads, str(out))
    assert out.exists() and out.stat().st_size > 1000


# ----------------------------------------------------------- train_selfplay

TINY = ["--games", "8", "--steps", "2", "--hidden", "16", "--buffer", "512", "--minibatch", "16",
        "--learn-iters", "2", "--device", "cpu"]


@pytest.mark.parametrize("algo", ["reinforce", "acer", "dqn"])
def test_train_selfplay_saves_params_that_reload(tmp_path, algo):
    from rl6nimmt_torch.experiments.train_selfplay import run

    path = str(tmp_path / f"{algo}.npz")
    params = run(["--algo", algo, "--save", path] + TINY)
    loaded = utils.load_params(path, params)
    for a, b in zip(tree_leaves(params), tree_leaves(loaded)):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    # The JAX package reads the same file into its own tree.
    first = jutils.load_params(path, {"trunk": [{"w": np.zeros(tuple(params["trunk"][0]["w"].shape)),
                                                  "b": np.zeros(tuple(params["trunk"][0]["b"].shape))}]})
    np.testing.assert_array_equal(first["trunk"][0]["w"], params["trunk"][0]["w"].numpy())


def test_train_selfplay_dp_over_two_gloo_ranks(tmp_path):
    from rl6nimmt_torch.experiments.train_selfplay import run

    path = str(tmp_path / "dp.npz")
    params = run(["--algo", "dqn", "--dp", "--world", "2", "--save", path] + TINY)
    loaded = utils.load_params(path, params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(loaded)):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="--world"):
        run(["--algo", "dqn", "--dp"] + TINY)
