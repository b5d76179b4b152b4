"""The experiment scripts' twins under ``rl6nimmt_torch/experiments`` at a tiny
size on the CPU: each ``main()`` runs and prints its result lines;
``train_puct_prior``'s loss and step equal the JAX script's
``imitation_loss`` and update on the same records and params (rtol 1e-5, atol
1e-6 times the largest magnitude, as tests/test_torch_dqn_cycle.py); and
``play_human`` finishes its games on scripted input."""

import builtins
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl6nimmt_tpu.agents.reinforce import action_in_input_logits as jax_logits
from rl6nimmt_tpu.nets import MLPSpec as JMLPSpec
from rl6nimmt_tpu.nets import mlp_init as jax_mlp_init
from rl6nimmt_torch.engine import EnvConfig
from rl6nimmt_torch.experiments import (fm_cycle_bench, fm_strength_ab, long_train_eval, micro_insert, play_human,
                                        strength_vs_budget, train_puct_prior)
from rl6nimmt_torch.nets import params_from_jax, params_to_numpy

RTOL, ATOL = 1e-5, 1e-6


def assert_f32_close(actual, desired, err_msg=""):
    desired = np.asarray(desired)
    scale = max(1.0, float(np.abs(desired).max()))
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=RTOL, atol=ATOL * scale, err_msg=err_msg)


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_fm_cycle_bench_runs_every_arm(capsys):
    result = fm_cycle_bench.main(["--games", "128", "--reps", "1", "--chain", "1", "--device", "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    assert [line["fm_cycle_bench"] for line in lines[:-1]] == list(fm_cycle_bench.ARMS)
    block = 128 * 10 * 4
    assert result["kernel_fm_aligned"]["per_physical_capacity"] == 204_800     # 200,000 rounded up to 5,120s
    for arm, r in result.items():
        assert r["ms_per_cycle"] > 0 and r["per_size"] == 2 * block, arm
    assert lines[-1]["device"] == "cpu"


def test_micro_insert_runs_every_arm(capsys):
    result = micro_insert.main(["--n", "64", "--capacity", "100", "--chain", "3", "--reps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert set(result) == set(micro_insert.ARMS)
    assert result["aligned"]["physical_capacity"] == result["aligned_fm"]["physical_capacity"] == 128
    assert result["ring"]["ptr"] == (7 * 64) % 100 and result["aligned"]["ptr"] == (7 * 64) % 128
    assert all(r["size"] == 100 for r in result.values())
    assert "aligned_over_ring" in out


def test_fm_strength_ab_trains_and_scores_each_arm(tmp_path, capsys):
    out = tmp_path / "ab.json"
    result = fm_strength_ab.main(["--seeds", "1", "--cycles", "1", "--games", "8", "--eval-games", "16",
                                  "--eval-keys", "1", "--out", str(out), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert len(re.findall(r"seed 0 \w+: score", printed)) == 3
    saved = json.loads(out.read_text())
    for arm in fm_strength_ab.ARMS:
        assert -104 * 10 <= saved[arm]["score_mean"] <= 0 and 0 <= saved[arm]["win_mean"] <= 1
    assert "kernel_fm_minus_engine_score" in result


def _records(cfg, seed, n_turns=3, G=4):
    rng = np.random.RandomState(seed)
    S, H, P = cfg.state_length, cfg.hand_size, cfg.num_players
    hands = np.sort(rng.choice(104, size=(n_turns, G, P, H)), axis=-1).astype(np.int32)
    count = rng.randint(1, H + 1, size=(n_turns, G, P))
    hands = np.where(np.arange(H) < count[..., None], hands, -1).astype(np.int32)
    return ({"obs": rng.randint(-1, 104, size=(n_turns, G, P, S)).astype(np.float32), "hands": hands,
             "picks": rng.randint(0, 10_000, size=(n_turns, G, P)) % count},
            rng.randint(-30, 1, size=(G, P)).astype(np.float32))


@pytest.mark.parametrize("objective", ["imitation", "advantage"])
def test_train_puct_prior_update_matches_jax(objective):
    """The port's loss and one step against the JAX script's ``imitation_loss``
    and ``update`` (experiments/train_puct_prior.py:83-111).  The step is SGD on
    both sides, as in every parameter comparison of the port (PARITY_TORCH.md
    section 13): the softmax is shift-invariant, so the head bias has a zero
    gradient up to round-off, and Adam's first step would move it by lr times
    the sign of that round-off."""
    cfg = EnvConfig(4)
    spec = train_puct_prior.prior_spec(cfg)
    jspec = JMLPSpec(input_size=spec.input_size, hidden_sizes=spec.hidden_sizes, head_sizes=spec.head_sizes)
    jparams = jax_mlp_init(jax.random.key(3), jspec)
    traj, scores = _records(cfg, 4)
    G = scores.shape[0]
    optimizer = optax.sgd(1e-2)

    def jax_loss(params):
        obs = jnp.asarray(traj["obs"]).reshape(-1, cfg.state_length)
        hands = jnp.asarray(traj["hands"]).reshape(-1, cfg.hand_size)
        picks = jnp.asarray(traj["picks"]).reshape(-1)
        if objective == "advantage":
            adv = scores - jnp.mean(scores, axis=1, keepdims=True)
            adv = adv / (jnp.std(adv) + 1e-6)
            weights = jnp.broadcast_to(adv[None], (traj["obs"].shape[0],) + adv.shape).reshape(-1)
        else:
            weights = jnp.ones(obs.shape[0])
        logits = jax.vmap(lambda s, c: jax_logits(jspec, params, s, c))(obs, hands)
        chosen = jnp.take_along_axis(jax.nn.log_softmax(logits), picks[:, None], axis=1)[:, 0]
        return -jnp.sum(weights * chosen) / G

    jl, grads = jax.value_and_grad(jax_loss)(jparams)
    updates, _ = optimizer.update(grads, optimizer.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, updates)

    from rl6nimmt_torch.agents.dqn import Sgd

    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    sgd = Sgd(1e-2)
    ttraj = {k: torch.tensor(v) for k, v in traj.items()}
    tnew, _, tl, mean_score = train_puct_prior.update(cfg, spec, sgd, tparams, sgd.init(tparams), ttraj,
                                                      torch.tensor(scores), objective)
    assert_f32_close(tl.numpy(), jl, "loss")
    assert float(mean_score) == pytest.approx(float(scores.mean()))
    for a, b in zip(jax.tree.leaves(params_to_numpy(tnew)), jax.tree.leaves(jax.tree.map(np.asarray, jnew))):
        assert_f32_close(a, b, "params after the step")


def test_train_puct_prior_runs_and_saves(tmp_path, capsys):
    out = tmp_path / "prior.npz"
    result = train_puct_prior.main(["--iters", "2", "--games", "2", "--mc-max", "4", "--eval-games", "4",
                                    "--eval-mc-max", "4", "--out", str(out), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "iter    0" in printed and "trained-vs-fresh" in printed and out.exists()
    assert 0.0 <= result["win_rate"] <= 1.0 and len(result["history"]) == 2
    assert all(np.isfinite(loss) and -104 * 10 <= score <= 0 for loss, score in result["history"])
    from rl6nimmt_torch.utils import load_params

    back = load_params(str(out), result["params"])
    for a, b in zip(jax.tree.leaves(params_to_numpy(back)), jax.tree.leaves(params_to_numpy(result["params"]))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("algo,flags", [("reinforce", ["--updates", "2", "--eval-every", "1", "--games", "4"]),
                                        ("dqn", ["--cycles", "2", "--games", "8"])])
def test_long_train_eval_trains_and_evaluates(algo, flags, tmp_path, capsys):
    history = long_train_eval.main(["--algo", algo, *flags, "--eval-games", "8", "--out", str(tmp_path),
                                    "--device", "cpu"])
    capsys.readouterr()
    assert len(history) == 3 and history[0]["loss"] is None
    assert all(0.0 <= h["win_rate"] <= 1.0 for h in history)
    assert all(np.isfinite(h["loss"]) for h in history[1:])
    assert (tmp_path / f"{algo}_params.npz").exists() and (tmp_path / f"{algo}_history.json").exists()


def test_long_train_eval_marks_as_jax():
    """The JAX script's eval marks: 8 log-spaced chunk multiples, or a cadence."""
    assert long_train_eval.reinforce_marks(20000, 0) == (312, sorted(
        {((int(19968 ** (i / 7)) + 311) // 312) * 312 for i in range(8)} | {19968}))
    assert long_train_eval.reinforce_marks(100, 25)[1] == [25, 50, 75, 100]
    assert long_train_eval.win_rate_from(np.array([[-1, -1, -5, -9], [-2, 0, -3, -4]])) == 0.25


@pytest.mark.parametrize("opponent", ["puct", "mcs"])
def test_strength_vs_budget_plays_alternated_games(opponent, capsys):
    result = strength_vs_budget.main(["--games", "2", "--big", "8", "--small", "4", "--opponent", opponent,
                                      "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "FINAL Alpha0.5@8 vs" in printed and result["games"] == 2
    assert 0.0 <= result["win_rate"] <= 1.0 and all(s <= 0 for s in result["mean_scores"])


def _scripted_faces():
    """Answers to the human prompts: card faces 1, 2, ..., 104 and again: each
    turn takes the lowest held card, the earlier faces re-prompting."""
    faces = iter([str(f) for f in range(1, 105)] * 20)
    prompts = []

    def scripted_input(prompt=""):
        prompts.append(prompt)
        return next(faces)
    return scripted_input, prompts


@pytest.mark.parametrize("device_game", [False, True], ids=["session", "device_game"])
def test_play_human_finishes_on_scripted_input(device_game, monkeypatch, capsys):
    scripted, prompts = _scripted_faces()
    monkeypatch.setattr(builtins, "input", scripted)
    argv = ["--games", "1", "--mc-max", "8", "--name", "Tester", "--device", "cpu"]
    totals = play_human.main(argv + (["--device-game"] if device_game else []))
    printed = capsys.readouterr().out
    assert "Series total: Tester" in printed
    assert len(totals) == 2 and all(t <= 0 for t in totals)
    assert any("Tester" in p for p in prompts)
