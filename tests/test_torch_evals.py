"""The evaluation, A/B and profiling scripts' twins under ``rl6nimmt_torch/experiments``
against the JAX scripts under ``experiments/``, on the CPU at small sizes.

* The arena scoring of ``device_learn_strength_ab`` and ``acer_onpolicy_ab``
  (seat 0's win rate against three random seats; the alternating-seat
  head-to-head) equals the JAX script's functions exactly, on converted params
  with JAX's dealt state and draws replayed (``torch_jax_noise.arena_noise``).
* Each reducer is the same function of the same score arrays as the JAX
  script's code, run here from the script's own lines (the scripts' module
  level sets up a compilation cache, so they are not imported): equal floats
  and strings, exactly.
* The committed trained prior loads through the port to JAX's arrays, bit for bit.
* ``puct_batch_ab`` deals every arm the same games; REINFORCE's two arms of
  ``device_learn_strength_ab`` end bit-equal; ``device_learn_speedup`` restores
  ``DeviceBlockSession.finalize`` when a block raises; every twin's ``main``
  finishes at a tiny size on the CPU.
"""

import ast
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl6nimmt_tpu.agents as jag
from rl6nimmt_tpu.nets import MLPSpec as JMLPSpec
from rl6nimmt_tpu.nets import mlp_init as jmlp_init
from rl6nimmt_tpu.runtime.arena import SeatPolicy as JSeatPolicy
from rl6nimmt_tpu.utils import load_params as jload_params
from rl6nimmt_torch import agents as tag
from rl6nimmt_torch.engine import EnvConfig
from rl6nimmt_torch.experiments import (acer_onpolicy_ab, arena_eval, budget_saturation, devblock_attrib,
                                        device_learn_speedup, device_learn_strength_ab, devroot_equivalence,
                                        prior_decoupled_eval, profile_devblock, puct_batch_ab)
from rl6nimmt_torch.nets import MLPSpec, params_from_jax, params_to_numpy
from torch_jax_noise import arena_noise

ROOT = Path(__file__).resolve().parents[1]
HID = (16,)
G = 24


def jax_functions(script, *names):
    """Top-level functions of ``experiments/<script>.py``, compiled alone."""
    path = ROOT / "experiments" / f"{script}.py"
    tree = ast.parse(path.read_text())
    nodes = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"np": np, "jax": jax, "jnp": jnp}
    exec(compile(ast.Module(body=nodes, type_ignores=[]), str(path), "exec"), ns)
    return [ns[n] for n in names]


def jax_lines(script, first, last, ns, starts):
    """Run lines ``first..last`` of ``experiments/<script>.py`` (one block,
    dedented) in the namespace ``ns``; the first line must start with ``starts``."""
    lines = (ROOT / "experiments" / f"{script}.py").read_text().splitlines(keepends=True)[first - 1:last]
    assert lines[0].strip().startswith(starts), (script, first, lines[0])
    ns.setdefault("np", np)
    exec(compile(textwrap.dedent("".join(lines)), f"{script}.py:{first}", "exec"), ns)
    return ns


def _learner(family, seed):
    """A JAX learner and the port's on its converted params."""
    name = {"per_dqn": "Noisy_D3QN_PRB_NStep", "reinforce": "BatchedReinforceAgent", "acer": "BatchedACERAgent"}[family]
    jagent = getattr(jag, name)(seed=seed, hidden_sizes=HID)
    tagent = getattr(tag, name)(seed=seed, hidden_sizes=HID, device="cpu")
    tagent.params = params_from_jax(jax.tree.map(np.asarray, jagent.params), "cpu")
    return jagent, tagent


def _jpolicy(family, jagent):
    if family == "per_dqn":
        return JSeatPolicy("dqn", jagent.spec, jagent.cfg)
    return JSeatPolicy("policy", jagent.spec)


@pytest.mark.parametrize("family", ["per_dqn", "acer", "reinforce"])
def test_strength_ab_arena_scoring_equals_jax(family):
    """``eval_policy`` and ``head_to_head`` of the twin equal the JAX script's
    (experiments/device_learn_strength_ab.py:75-108) on JAX's deals and draws."""
    j_eval, j_h2h = jax_functions("device_learn_strength_ab", "eval_policy", "head_to_head")
    (ja, ta), (jb, tb) = _learner(family, 3), _learner(family, 4)
    rand = JSeatPolicy("random")
    noise = arena_noise((_jpolicy(family, ja),) + (rand,) * 3, G, 70)
    got = device_learn_strength_ab.eval_policy(family, ta, G, 70, "cpu", noise=noise)
    assert got == j_eval(family, ja, G, 70)
    pa, pb = _jpolicy(family, ja), _jpolicy(family, jb)
    noises = (arena_noise((pa, pb), G, 80), arena_noise((pb, pa), G, 81))
    got = device_learn_strength_ab.head_to_head(family, ta, tb, G, 80, "cpu", noises=noises)
    assert got == j_h2h(family, ja, jb, G, 80)


def test_acer_onpolicy_arena_scoring_equals_jax():
    """``arena_vs_random`` and ``head_to_head`` (rate, standard error, games)
    equal the JAX script's (experiments/acer_onpolicy_ab.py:73-98)."""
    j_vs_random, j_h2h = jax_functions("acer_onpolicy_ab", "arena_vs_random", "head_to_head")
    from rl6nimmt_tpu.engine import EnvConfig as JEnvConfig

    jcfg, cfg = JEnvConfig(num_players=4), EnvConfig(num_players=4)
    jspec = JMLPSpec(input_size=1 + jcfg.state_length, hidden_sizes=HID, head_sizes=(1, 1))
    spec = MLPSpec(input_size=1 + cfg.state_length, hidden_sizes=HID, head_sizes=(1, 1))
    jparams = [jmlp_init(jax.random.key(s), jspec) for s in (5, 6)]
    tparams = [params_from_jax(jax.tree.map(np.asarray, p), "cpu") for p in jparams]
    pol, rand = JSeatPolicy("policy", jspec), JSeatPolicy("random")
    got = acer_onpolicy_ab.arena_vs_random(cfg, spec, tparams[0], G, 7, "cpu",
                                           noise=arena_noise((pol,) + (rand,) * 3, G, 7))
    assert got == j_vs_random(jcfg, jspec, jparams[0], G, 7)
    noises = (arena_noise((pol, pol), G, 17), arena_noise((pol, pol), G, 18))
    got = acer_onpolicy_ab.head_to_head(spec, tparams[0], tparams[1], G, 17, "cpu", noises=noises)
    assert got == j_h2h(jspec, jparams[0], jparams[1], G, 17)


def _score_arrays(seed, games=40, players=2):
    return np.random.RandomState(seed).randint(-20, 1, size=(games, players)).astype(np.float32)


@pytest.mark.parametrize("segments", [([60.0, 62.5, 58.1], [30.2, 31.0, 29.9]), ([40.0], [41.0]),
                                      ([5.0 + i for i in range(13)], [5.5 + 0.9 * i for i in range(13)]),
                                      ([10.0, 10.0], [20.0, 19.0])])
def test_speedup_interval_and_verdict_equal_jax(segments):
    """``ci95`` and the verdict (experiments/device_learn_speedup.py:127-136, 150-158)."""
    seg = {"host": list(segments[0]), "device": list(segments[1])}
    ns = jax_lines("device_learn_speedup", 127, 136, {}, "T_95 = ")
    ns["segments"] = seg
    jax_lines("device_learn_speedup", 150, 158, ns, "host_m, host_ci = ")
    host = device_learn_speedup.ci95(seg["host"])
    ratios = [h / d for h, d in zip(seg["host"], seg["device"])]
    ratio = device_learn_speedup.ci95(ratios)
    np.testing.assert_equal(host, (ns["host_m"], ns["host_ci"]))
    np.testing.assert_equal(ratio, (ns["ratio_m"], ns["ratio_ci"]))
    assert device_learn_speedup.verdict(*ratio) == ns["verdict"]


def test_puct_batch_paired_delta_equals_jax():
    """experiments/puct_batch_ab.py:84-92 on three arms' [keys, G] seat-0 scores."""
    ks = [8, 16, 32]
    scores = {k: _score_arrays(k, 24, 3) for k in ks}
    ns = jax_lines("puct_batch_ab", 84, 92, {"ks": ks, "scores": scores,
                                             "result": {"arms": {str(k): {} for k in ks}}}, "base = ks[0]")
    for k in ks[1:]:
        assert puct_batch_ab.paired_delta(scores[k], scores[8]) == ns["result"]["arms"][str(k)]["paired_delta_vs_base"]


@pytest.mark.parametrize("wins,n", [(100.0, 200), (120.5, 200), (1.0, 2), (0.0, 7)])
def test_devroot_z_and_verdict_equal_jax(wins, n):
    """experiments/devroot_equivalence.py:67-71."""
    ns = jax_lines("devroot_equivalence", 67, 71, {"args": SimpleNamespace(games=n), "wins_d": wins}, "n = args")
    assert devroot_equivalence.equivalence(wins, n) == (ns["rate"], ns["z"], ns["verdict"])


def test_budget_saturation_and_prior_eval_rates_equal_jax():
    """The win rate with its standard error: experiments/budget_saturation.py:75-79
    over both seat orders, and prior_decoupled_eval.py's ``head_to_head``
    (:43-52) with its matches replaced by fixed score arrays."""
    s0, s1 = _score_arrays(1), _score_arrays(2)
    ns = {"wins": 0, "ties": 0, "n": 0, "G": s0.shape[0]}
    wins = ties = 0.0
    for low_seat, s in ((0, s0), (1, s1)):
        ns.update(low_seat=low_seat, s=s)
        jax_lines("budget_saturation", 75, 77, ns, "wins += ")
        w, t = budget_saturation.seat_record(s, low_seat)
        wins, ties = wins + w, ties + t
    jax_lines("budget_saturation", 78, 79, ns, "rate = ")
    assert budget_saturation.rate_and_se(wins, ties, ns["n"]) == (ns["rate"], ns["se"])

    (j_h2h,) = jax_functions("prior_decoupled_eval", "head_to_head")
    want = j_h2h(lambda params, key: s0, lambda params, key: s1, None, None, jax.random.key(0))
    assert arena_eval.alternating_record(s0, s1) == want
    got = prior_decoupled_eval.head_to_head(lambda params, gen: torch.from_numpy(s0),
                                            lambda params, gen: torch.from_numpy(s1), None, None, None)
    assert got == want


def test_strength_summary_equals_jax():
    """One family's record: experiments/device_learn_strength_ab.py:143-160."""
    rng = np.random.RandomState(3)
    host_w, dev_w, h2h = (list(rng.uniform(0.2, 0.6, 4)) for _ in range(3))
    equal = [True, False, True, True]
    args = SimpleNamespace(seeds=4, games=240, block=120, eval_games=4096)
    ns = jax_lines("device_learn_strength_ab", 143, 160, {"host_w": host_w, "dev_w": dev_w, "h2h": h2h, "args": args,
                                                          "out": {}, "family": "acer", "params_equal": equal},
                   "host_w, dev_w, h2h = map")
    assert device_learn_strength_ab.summarize(host_w, dev_w, h2h, equal, 4, 240, 120, 4096) == ns["out"]["acer"]


def test_committed_prior_loads_as_jax():
    """The trained prior's npz through the port's ``load_params`` gives JAX's arrays."""
    path = str(ROOT / prior_decoupled_eval.DEFAULT_PARAMS)
    cfg = EnvConfig(num_players=2)
    spec = MLPSpec(input_size=cfg.state_length + 1, hidden_sizes=(100, 100), head_sizes=(1,))
    jspec = JMLPSpec(input_size=cfg.state_length + 1, hidden_sizes=(100, 100), head_sizes=(1,))
    from rl6nimmt_torch.nets import mlp_init
    from rl6nimmt_torch.utils import load_params

    got = load_params(path, mlp_init(torch.Generator().manual_seed(1234), spec, "cpu"))
    want = jload_params(path, jmlp_init(jax.random.key(1234), jspec))
    got, want = jax.tree.leaves(params_to_numpy(got)), jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_puct_batch_arms_are_dealt_the_same_games(monkeypatch, tmp_path, capsys):
    """Every K plays match e from a generator seeded 1000 + e, whose first draw is the deal's seed."""
    from rl6nimmt_torch.runtime import device_match

    dealt, real_deal = [], device_match.deal
    monkeypatch.setattr(device_match, "deal", lambda *a, **k: dealt.append(real_deal(*a, **k)) or dealt[-1])
    result = puct_batch_ab.main(["--games", "2", "--keys", "2", "--ks", "4,8", "--mc-max", "8",
                                 "--out", str(tmp_path / "ab.json"), "--device", "cpu"])
    capsys.readouterr()
    assert len(dealt) == 4
    for e in range(2):
        a, b = dealt[e], dealt[2 + e]
        assert torch.equal(a.hands, b.hands) and torch.equal(a.board, b.board)
    assert not torch.equal(dealt[0].hands, dealt[1].hands)
    assert result["arms"]["8"]["paired_delta_vs_base"]["n"] == 4
    assert all(-104 * 10 <= arm["mean_score"] <= 0 and 0 <= arm["win_rate"] <= 1 for arm in result["arms"].values())


def test_reinforce_arms_are_bit_equal(tmp_path, capsys):
    result = device_learn_strength_ab.main(["--seeds", "1", "--games", "4", "--block", "2", "--eval-games", "16",
                                            "--families", "reinforce", "--out", str(tmp_path / "s.json"),
                                            "--device", "cpu"])
    assert "[reinforce seed 0]" in capsys.readouterr().out
    r = result["reinforce"]
    assert r["final_params_bit_equal_per_seed"] == [True]
    assert r["win_vs_3_random_host"] == r["win_vs_3_random_device"] and 0 <= r["head_to_head_device_mean"] <= 1


def test_speedup_restores_finalize_when_a_block_raises(monkeypatch):
    from rl6nimmt_torch.runtime import device_tournament
    from rl6nimmt_torch.tournament import Tournament

    original = device_tournament.DeviceBlockSession.finalize
    real_play = Tournament.play_device_block
    calls = []

    def play_then_raise(self, *a, **k):
        calls.append(device_tournament.DeviceBlockSession.finalize)
        if len(calls) == 2:
            raise RuntimeError("block failed")
        return real_play(self, *a, **k)

    monkeypatch.setattr(Tournament, "play_device_block", play_then_raise)
    with pytest.raises(RuntimeError, match="block failed"):
        device_learn_speedup.run(True, 4, 2, 0, torch.device("cpu"))
    assert calls[0] is not original                       # patched while the blocks ran
    assert device_tournament.DeviceBlockSession.finalize is original


def _speedup_checks(r, out):
    for arm in ("host", "device"):
        assert r[arm]["games"] == 2 and r[arm]["ms_per_game"] > 0 and set(r[arm]["splits_s"]) == {
            "assemble_s", "device_s", "replay_s"}
    assert r["speedup"] > 0 and "speedup_host_over_device" in out


def _pairs_checks(r, out):
    assert len(r["host_ms_per_game"]["all"]) == len(r["device_ms_per_game"]["all"]) == 2
    assert r["verdict"] in {device_learn_speedup.verdict(m, c) for m, c in ((2, 0.5), (0.5, 0.1), (1, 1))}
    assert "pair 1 host" in out


def _profile_checks(r, out):
    assert [b["label"] for b in r.values()] == ["cold", "warm"]
    assert all(sum(g["games"] for g in b["groups"]) == 4 for b in r.values()) and "[warm] block total" in out


def _budget_checks(r, out):
    assert set(r) == {"4", "8"} and all(0 <= v["win_rate_vs_saturated"] <= 1 and v["games"] == 4 for v in r.values())


def _attrib_checks(r, out):
    names = ["random", "mcs", "puct_uniform", "puct", "mcs/puct_free", "mcs/pf+uni", "puct/K32"]
    assert list(r) == names and all(v["min_ms"] > 0 for v in r.values())
    assert "mcs/pf+uni" in out


def _prior_checks(r, out):
    assert list(r) == ["A@4", "B@4", "C@4", "D@4"] and all(0 <= v["win_rate_A"] <= 1 and v["games"] == 4
                                                           for v in r.values())


def _devroot_checks(r, out):
    assert r["games"] == 2 and 0 <= r["device_root_win_rate"] <= 1 and r["mean_score_device"] <= 0
    assert '"verdict"' in out


def _acer_checks(r, out):
    for arm in ("all_fresh", "subsampled"):
        assert 0 <= r[arm]["win_vs_3_random"] <= 1 and -104 * 10 <= r[arm]["final_mean_score"] <= 0
        assert r[arm]["peak_device_memory_bytes"] is None
    assert r["all_fresh_win_vs_subsampled"]["games"] == 32


TINY = {
    "device_learn_speedup": (device_learn_speedup, ["--games", "4", "--block", "2"], _speedup_checks, True),
    "device_learn_speedup_pairs": (device_learn_speedup, ["--games", "4", "--block", "2", "--pairs", "2"],
                                   _pairs_checks, True),
    "profile_devblock": (profile_devblock, ["--games", "4", "--mc-max", "4", "--blocks", "2"], _profile_checks, False),
    "budget_saturation": (budget_saturation, ["--budgets", "4,8", "--reference-budget", "8", "--games", "2"],
                          _budget_checks, True),
    "devblock_attrib": (devblock_attrib, ["--games", "2", "--players", "2", "--mc-max", "4", "--reps", "1"],
                        _attrib_checks, False),
    "prior_decoupled_eval": (prior_decoupled_eval, ["--games", "2", "--budgets", "4",
                                                    "--params", str(ROOT / prior_decoupled_eval.DEFAULT_PARAMS)],
                             _prior_checks, False),
    "devroot_equivalence": (devroot_equivalence, ["--games", "2", "--mc-max", "4", "--agent", "mcs"],
                            _devroot_checks, False),
    "acer_onpolicy_ab": (acer_onpolicy_ab, ["--games", "4", "--steps", "1", "--eval-games", "16", "--on-policy", "4"],
                         _acer_checks, True),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_twin_main_finishes_on_the_cpu(name, tmp_path, capsys):
    module, argv, check, writes = TINY[name]
    out_path = tmp_path / "out.json"
    result = module.main(argv + (["--out", str(out_path)] if writes else []) + ["--device", "cpu"])
    check(result, capsys.readouterr().out)
    if writes:
        assert out_path.exists()
