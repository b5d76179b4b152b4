"""The weak-scaling bench's twin and the DP REINFORCE step it times, against
the JAX package's ``shard_map`` step.

JAX's ``make_dp_reinforce_step`` runs on ``make_mesh(num_devices=n)`` over
conftest's virtual CPU devices; device r draws its games from ``keys[r]``.
The port's step runs over n gloo ranks (one spawn of two ranks,
``runtime/dp_check.run_checks`` with meshes of 1 and 2 ranks), rank r on the
same draws replayed (``replay_rollout(keys[r], G)``) from the same params.
Over two steps the mean score must be equal (the same games were played), the
loss and, under SGD, the params within ``PARITY_TORCH.md`` section 7 (rtol
1e-5, atol 1e-6 times the largest magnitude; under Adam the losses only, as in
``tests/test_torch_reinforce.py``), and the params bit-identical across ranks.
"""

import json
from pathlib import Path

import jax
import numpy as np
import optax
import pytest

from rl6nimmt_tpu.engine import EnvConfig as JaxConfig
from rl6nimmt_tpu.nets import MLPSpec as JMLPSpec
from rl6nimmt_tpu.nets import mlp_init as jmlp_init
from rl6nimmt_tpu.parallel import make_dp_reinforce_step as jax_dp_reinforce_step
from rl6nimmt_tpu.parallel import make_mesh as jax_make_mesh
from test_torch_reinforce import _np, assert_f32_close, replay_rollout

ROOT = Path(__file__).resolve().parents[1]
G, HIDDEN, STEPS = 8, (16,), 2
LR = {"sgd": 1e-2, "adam": 1e-3}
JCFG = JaxConfig(4)
JSPEC = JMLPSpec(JCFG.state_length + 1, hidden_sizes=HIDDEN, head_sizes=(1,))


def _keys(n):
    """Each step's per-device keys over a mesh of ``n`` devices."""
    return [jax.random.split(jax.random.key(71 + s), n) for s in range(STEPS)]


@pytest.fixture(scope="module")
def params():
    return jmlp_init(jax.random.key(70), JSPEC)


@pytest.fixture(scope="module")
def ranks(params):
    from rl6nimmt_torch.parallel.launch import spawn
    from rl6nimmt_torch.runtime.dp_check import run_checks

    draws = {}
    for n in (1, 2):
        draws[n] = []
        for keys in _keys(n):
            rnd = [replay_rollout(keys[r], G) for r in range(n)]
            draws[n].append([{"gumbel": x.gumbel.numpy(), "decks": x.decks.numpy()} for x in rnd])
    case = {"params": _np(params), "hidden": HIDDEN, "games": G, "lr": LR, "randomness": draws}
    return spawn(run_checks, 2, {"reinforce_steps": case}, "cpu", timeout=300)[0]["reinforce_steps"]


@pytest.mark.parametrize("opt", sorted(LR))
@pytest.mark.parametrize("n", (1, 2))
def test_dp_reinforce_step_matches_jax_shard_map_step(ranks, params, n, opt):
    joptimizer = optax.sgd(LR[opt]) if opt == "sgd" else optax.adam(LR[opt])
    jstep = jax_dp_reinforce_step(JCFG, JSPEC, joptimizer, games_per_device=G, mesh=jax_make_mesh(num_devices=n))
    jparams, jstate = params, joptimizer.init(params)
    got = ranks[f"n{n}"][opt]
    assert got["replicated"]
    for i, keys in enumerate(_keys(n)):
        jparams, jstate, jm = jstep(jparams, jstate, keys)
        step = got["steps"][i]
        assert step["mean_score"] == float(jm["mean_score"])     # the same games were played
        assert_f32_close(step["loss"], float(jm["loss"]), f"loss, step {i}")
        if opt == "sgd":
            for a, b in zip(jax.tree.leaves(step["params"]), jax.tree.leaves(_np(jparams))):
                assert_f32_close(a, b, f"params, step {i}")


@pytest.mark.parametrize("n_total", (1, 3, 8))
def test_sweep_sizes_are_the_jax_scripts(n_total):
    """The world sizes are what the JAX script's own line gives for ``n_total`` devices."""
    from rl6nimmt_torch.experiments.scaling_bench import device_counts

    source = (ROOT / "experiments" / "scaling_bench.py").read_text()
    line = next(s.strip() for s in source.splitlines() if s.strip().startswith("sizes = "))
    assert device_counts(n_total) == eval(line.split("=", 1)[1], {"n_total": n_total})


def test_twin_sweeps_gloo_ranks_on_the_cpu(capsys):
    from rl6nimmt_torch.experiments.scaling_bench import main

    out = main(["--device", "cpu", "--backend", "gloo", "--max-devices", "2", "--games-per-device", "8",
                "--steps", "2"])
    printed = capsys.readouterr().out.strip().splitlines()
    jax_keys = {"devices", "ms_per_update", "games_per_s", "efficiency"}
    assert [r["devices"] for r in out["rows"]] == [1, 2]
    assert all(set(r) == jax_keys for r in out["rows"])
    assert all(np.isfinite(r[k]) and r[k] > 0 for r in out["rows"] for k in jax_keys)
    assert out["rows"][0]["efficiency"] == 1.0
    assert out["virtual_mesh"] is True
    assert json.loads(printed[-1]) == {"virtual_mesh": True, "rows": out["rows"]}
    assert sum("code-path check only" in line for line in printed) == 2
    for world in out["worlds"]:
        assert len(world["ranks"]) == world["devices"] and world["shared"]
        assert len({r["params_digest"] for r in world["ranks"]}) == 1
        assert all(r["launches"] == {} for r in world["ranks"])       # the plain twins on the CPU
        assert all(np.isfinite(r["metrics"]["loss"]) and r["metrics"]["mean_score"] < 0 for r in world["ranks"])

