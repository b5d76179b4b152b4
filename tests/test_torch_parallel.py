"""Data parallel on the port: gloo ranks on the CPU against the port's own
single-rank steps and against JAX's single-device steps.

One spawn of four gloo ranks (``parallel.launch.spawn`` of
``runtime/dp_check.run_checks``) runs every multi-rank check at once, on
meshes of 1, 2 and 4 ranks and a 2 x 2 two-level mesh; the tests read its
results.  The ranks import only ``rl6nimmt_torch``: the JAX references are
computed here and the inputs passed to the ranks as numpy.

The properties are those of ``tests/test_dp_sync.py`` (an N-rank DQN or ACER
update equals a single update on the concatenated minibatch, at that test's
tolerances: atol 1e-6, rtol 1e-6 for the DQN, rtol 1e-5 for ACER's losses;
the non-noisy configs ``vanilla`` and ``d3qn_prb``; SGD for ACER) and of
``tests/test_vector_runtime.py`` (replicated params stay bit-identical across
ranks, a cycle re-runs deterministically); the port's single update is held
to JAX's at ``PARITY_TORCH.md`` section 7's tolerance (rtol 1e-5, atol 1e-6
times the largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl6nimmt_tpu.agents.acer import make_acer_train_step as jax_acer_train_step
from rl6nimmt_tpu.agents.dqn import DQNConfig as JDQNConfig
from rl6nimmt_tpu.agents.dqn import make_learn_step as jax_learn_step
from rl6nimmt_tpu.agents.dqn import q_network_spec as jq_network_spec
from rl6nimmt_tpu.nets import MLPSpec as JMLPSpec
from rl6nimmt_tpu.nets import mlp_init as jmlp_init

S, H = 47, 10
CONFIGS = {"vanilla": dict(hidden_sizes=(16,)),
           "d3qn_prb": dict(double=True, dueling=True, per=True, hidden_sizes=(16,))}
DQN_BATCH = 64          # 16 a rank on the 4-rank mesh
ACER_B, ACER_T = 16, 10
MESHES = ("n2", "n4", "2x2")
CYCLE = {"cfg": dict(double=True, per=True, hidden_sizes=(16,), minibatch=16), "games": 2, "learn_iters": 2,
         "capacity": 512}
RTOL, ATOL = 1e-5, 1e-6


def assert_f32_close(actual, desired, err_msg=""):
    desired = np.asarray(desired)
    scale = max(1.0, float(np.abs(desired).max()))
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=RTOL, atol=ATOL * scale, err_msg=err_msg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def global_dqn_batch(rng, n):
    return {
        "state": rng.randn(n, S).astype(np.float32),
        "action": rng.randint(0, 104, n).astype(np.int32),
        "reward": rng.randn(n).astype(np.float32),
        "next_state": rng.randn(n, S).astype(np.float32),
        "done": (rng.random(n) < 0.3).astype(np.float32),
        "weights": rng.random(n).astype(np.float32) + 0.5,
    }


def acer_batch(rng):
    B, T = ACER_B, ACER_T
    cards = np.sort(np.stack([rng.choice(104, size=H, replace=False) for _ in range(B * T)]),
                    axis=1).reshape(B, T, H).astype(np.int32)
    logits = rng.randn(B, T, H).astype(np.float32)
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return {
        "state": rng.randn(B, T, S).astype(np.float32),
        "legal_cards": cards,
        "log_probs": log_probs.astype(np.float32),
        "action_id": rng.randint(0, H, (B, T)).astype(np.int32),
        "reward": rng.randn(B, T).astype(np.float32),
        "done": (rng.random((B, T)) < 0.1).astype(np.float32),
        # Equal lengths: each rank's step-count weighting is then a plain
        # local mean, so the mean over ranks is the global mean.
        "length": np.full((B,), T, np.int32),
    }


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    dqn = {}
    for i, (name, kw) in enumerate(CONFIGS.items()):
        spec = jq_network_spec(JDQNConfig(**kw), S, 104)
        dqn[name] = {"cfg": kw, "params": _np(jmlp_init(jax.random.key(2 * i), spec)),
                     "target": _np(jmlp_init(jax.random.key(2 * i + 1), spec)),
                     "batch": global_dqn_batch(rng, DQN_BATCH)}
    acer_spec = JMLPSpec(input_size=1 + S, hidden_sizes=(16,), head_sizes=(1, 1))
    acer = {"params": _np(jmlp_init(jax.random.key(3), acer_spec)), "batch": acer_batch(rng)}
    return {"dqn_learn": dqn, "acer_train": acer, "dqn_cycle": CYCLE, "reinforce_games": 4, "acer_games": 4,
            "block_games": 8}


@pytest.fixture(scope="module")
def ranks(inputs):
    from rl6nimmt_torch.parallel.launch import spawn
    from rl6nimmt_torch.runtime.dp_check import run_checks

    return spawn(run_checks, 4, inputs, "cpu", timeout=300)[0]


def _jax_dqn(case):
    cfg = JDQNConfig(**case["cfg"])
    spec = jq_network_spec(cfg, S, 104)
    opt = optax.adam(1e-3)
    params = jax.tree.map(jnp.asarray, case["params"])
    target = jax.tree.map(jnp.asarray, case["target"]) if cfg.double else None
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    p, t, o, loss, _, _ = jax_learn_step(cfg, spec, opt, gamma=0.99)(
        params, target, opt.init(params), batch, True, jax.random.key(2))
    return p, t, o, loss


def _tree_allclose(a, b, atol=1e-6, rtol=1e-6):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol, rtol=rtol)


# ------------------------------------------------------------------ pmean


@pytest.mark.parametrize("mesh", ("n1",) + MESHES)
def test_pmean_fused_equals_per_leaf_means(ranks, mesh):
    """One flat all-reduce equals one a leaf (to the sums' order), and one
    rank, or no group, gives the tree back bit for bit."""
    got = ranks["pmean"][mesh]
    assert got["max_err"] <= 1e-6
    assert got["identity"]


def test_pmean_fused_without_a_group_is_the_identity():
    from rl6nimmt_torch.utils.ops import pmean_fused

    tree = {"w": torch.ones(2, 3), "b": [torch.zeros(3)]}
    assert pmean_fused(tree, None) is tree


# --------------------------------------------------------- DQN and ACER


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("cfg", CONFIGS)
def test_dqn_dp_learn_equals_one_rank_on_the_global_batch(ranks, cfg, mesh):
    one, dp = ranks["learn"][(cfg, "plain")], ranks["learn"][(cfg, mesh)]
    np.testing.assert_allclose(dp["loss"], one["loss"], rtol=1e-6)
    _tree_allclose(dp["params"], one["params"])
    _tree_allclose((dp["adam"]["mu"], dp["adam"]["nu"]), (one["adam"]["mu"], one["adam"]["nu"]))
    if CONFIGS[cfg].get("double"):
        _tree_allclose(dp["target"], one["target"])
    assert ranks["replicated"][f"learn_{cfg}_{mesh}"]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_dqn_one_rank_learn_matches_jax(ranks, inputs, cfg):
    p, t, o, loss = _jax_dqn(inputs["dqn_learn"][cfg])
    for mesh in ("plain", "n1"):
        got = ranks["learn"][(cfg, mesh)]
        assert_f32_close(got["loss"], float(loss))
        for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(_np(p))):
            assert_f32_close(a, b, err_msg=f"{cfg} {mesh} params")
        for a, b in zip(jax.tree.leaves(got["adam"]["mu"]), jax.tree.leaves(_np(o[0].mu))):
            assert_f32_close(a, b, err_msg=f"{cfg} {mesh} adam mu")
        if t is not None:
            for a, b in zip(jax.tree.leaves(got["target"]), jax.tree.leaves(_np(t))):
                assert_f32_close(a, b, err_msg=f"{cfg} {mesh} target")


@pytest.mark.parametrize("mesh", MESHES)
def test_acer_dp_train_equals_one_rank_on_the_global_batch(ranks, mesh):
    one, dp = ranks["acer"]["plain"], ranks["acer"][mesh]
    for a, b in zip(dp["losses"], one["losses"]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)
    _tree_allclose(dp["params"], one["params"])
    assert ranks["replicated"][f"acer_{mesh}"]


def test_acer_one_rank_train_matches_jax(ranks, inputs):
    case = inputs["acer_train"]
    spec = JMLPSpec(input_size=1 + S, hidden_sizes=(16,), head_sizes=(1, 1))
    opt = optax.sgd(1e-2)
    params = jax.tree.map(jnp.asarray, case["params"])
    p, _, losses = jax.jit(jax_acer_train_step(spec, opt))(
        params, opt.init(params), {k: jnp.asarray(v) for k, v in case["batch"].items()})
    for mesh in ("plain", "n1"):
        got = ranks["acer"][mesh]
        for a, b in zip(got["losses"], losses):
            assert_f32_close(a, float(b))
        for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(_np(p))):
            assert_f32_close(a, b, err_msg=mesh)


# ------------------------------------------------------------ the cycles


@pytest.mark.parametrize("mesh", ("n1",) + MESHES)
@pytest.mark.parametrize("algo", ("dqn_cycle", "reinforce"))
def test_dp_cycles_keep_params_replicated_and_rerun_deterministically(ranks, algo, mesh):
    assert ranks["replicated"][f"{algo}_{mesh}"]
    assert ranks["rerun"][f"{algo}_{mesh}"]


@pytest.mark.parametrize("mesh", ("n1",) + MESHES)
def test_dp_dqn_cycle_makes_one_allreduce_an_update(ranks, mesh):
    """One all-reduce a Bellman update and one for the cycle's mean score, on
    each of the groups a reduce runs through (two on the 2-level mesh)."""
    levels = 2 if mesh == "2x2" else 1
    assert ranks["allreduces"][f"dqn_{mesh}"] == levels * (CYCLE["learn_iters"] + 1)


@pytest.mark.parametrize("algo", ("reinforce", "dqn", "acer"))
def test_world_size_one_dp_step_is_the_plain_step(ranks, algo):
    assert ranks["size1"][algo]


# ------------------------------------------------------------ the block


@pytest.mark.parametrize("mesh", ("n2", "n4"))
def test_sharded_device_block_equals_the_unsharded_block(ranks, mesh):
    """test_device_tournament.py's property: the games sharded over the
    ranks score as on one rank (the same np.random state)."""
    np.testing.assert_array_equal(ranks["block"][mesh], ranks["block"]["n1"])
    assert ranks["block"]["n1"].shape == (8, 2) and (ranks["block"]["n1"] <= 0).all()
    assert ranks["tournament"][mesh] == ranks["tournament"]["n1"]


def test_mesh_block_plays_the_block_fn_on_the_whole_blocks_noise(ranks):
    """Every mesh's block equals the block function on the whole block's noise
    (``draw_block_noise`` from the session's generator): the mesh-free block
    of the same games and draws."""
    np.testing.assert_array_equal(ranks["block"]["n1"], ranks["block"]["fn"])


# ------------------------------------------------------ the mesh itself


def test_mesh_needs_a_process_group_and_backends_do_not_switch():
    from rl6nimmt_torch.parallel import make_mesh, make_mesh_2level
    from rl6nimmt_torch.parallel.launch import check_backend

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh_2level(2, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        check_backend("mpi", 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            check_backend("nccl", 1)


def test_parallel_exports_jax_names():
    import rl6nimmt_torch.parallel as port
    import rl6nimmt_tpu.parallel as ref

    assert port.__all__ == ref.__all__
    assert (port.GAMES_AXIS, port.DCN_AXIS, port.ICI_AXIS) == (ref.GAMES_AXIS, ref.DCN_AXIS, ref.ICI_AXIS)


@pytest.mark.slow
def test_multiprocess_dp_two_ranks_match_one_rank():
    """The twin of tests/test_multiprocess.py: 2 ranks x 1 and 1 rank play the
    same games (the step's randomness is drawn over all of them and sharded),
    so the metrics agree and the params agree up to the all-reduce's order."""
    from rl6nimmt_torch.experiments.multiprocess_dp import launch, main

    args = lambda n: __import__("argparse").Namespace(num_processes=n, games=32, steps=2, seed=0,
                                                      algo="reinforce", backend="gloo", device="cpu",
                                                      timeout=300.0)
    multi, single = launch(args(2)), launch(args(1))
    assert multi["global_devices"] == 2 and single["global_devices"] == 1
    assert multi["params_replicated_across_processes"]
    assert multi["metrics"] == pytest.approx(single["metrics"], rel=1e-6)
    assert multi["params_l1"] == pytest.approx(single["params_l1"], rel=1e-5)
    assert main(["--num-processes", "2", "--games", "8", "--steps", "1", "--device", "cpu"]) == 0
