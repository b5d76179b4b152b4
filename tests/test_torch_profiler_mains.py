"""Every profiler, micro-benchmark and debug script twin of
``rl6nimmt_torch/experiments`` finishes its ``main`` on the CPU at a tiny
size (a few games, chains of one), with the results it returns well formed."""

import math

import pytest

from rl6nimmt_torch.experiments import (act_rollout_probe, bench_trainable, debug_acer, debug_dqn, debug_gradflow,
                                        debug_mcts, micro_acer, micro_cycle, micro_cycle2, micro_cycle3, micro_cycle4,
                                        micro_cycle5, micro_per, profile_ab, profile_trainable, roofline_cycle)

SHORT = ["--chain", "1", "--iters", "1", "--games", "8", "--device", "cpu"]


def _finite(values):
    return all(isinstance(v, float) and math.isfinite(v) and v > 0 for v in values)


def _check_micro(out):
    assert out and _finite(out.values())


def _check_micro2(out):
    raised = {k for k, v in out.items() if isinstance(v, str)}
    assert raised == {"cap=16384 li=1 (fits VMEM-ish)", "cap=16384 li=0"}
    assert all("exceeds buffer capacity 16384" in out[k] for k in raised)
    assert _finite(v for k, v in out.items() if k not in raised)


def _check_probe(out):
    assert out["structural_fails"] == [] and out["action_agreement"] >= 0.999
    assert out["score_agreement"] >= 0.999 and out["ms_per_generation"] > 0


def _check_roofline(out):
    assert set(out["phases"]) == {"rollout", "harvest_insert", "learn_8_updates"}
    assert out["total_floor_ms"] > 0 and out["binding_constraint"].split(":")[0] in out["phases"]


def _check_bench(out):
    assert set(out) == {"reinforce", "dqn", "acer"} and all(v["value"] > 0 for v in out.values())


def _check_profile(out):
    assert out["reinforce"]["full_cycle_ms"] > 0 and out["dqn"]["1_update_ms"] > 0


def _check_ab(out):
    assert all(0 <= x <= 1 for fam in out.values() for k in fam["win_vs_3_random"]
               for x in fam["win_vs_3_random"][k])


def _check_session(out):
    assert len(out) >= 1 and all((r <= 0).all() for r in out)


def _check_gradflow(out):
    stats, _ = out
    assert set(stats) >= {"trunk/0/w", "heads/1/w"} and all(math.isfinite(s["max_abs"]) for s in stats.values())


CASES = {
    "micro_cycle": (micro_cycle, SHORT, _check_micro),
    "micro_cycle2": (micro_cycle2, SHORT, _check_micro2),
    "micro_cycle3": (micro_cycle3, SHORT, _check_micro),
    "micro_cycle4": (micro_cycle4, SHORT, _check_micro),
    "micro_cycle5": (micro_cycle5, SHORT, _check_micro),
    "micro_per": (micro_per, ["--chain", "1", "--iters", "1", "--device", "cpu"], _check_micro),
    "micro_acer": (micro_acer, SHORT, _check_micro),
    "act_rollout_probe": (act_rollout_probe, ["--chain", "2", "--iters", "1", "--games", "8", "--device", "cpu"],
                          _check_probe),
    "roofline_cycle": (roofline_cycle, ["--chain", "1", "--reps", "1", "--games", "8", "--device", "cpu"],
                       _check_roofline),
    "bench_trainable": (bench_trainable, ["--games", "8", "--device", "cpu"], _check_bench),
    "bench_trainable_bf16": (bench_trainable, ["--games", "8", "--dtype", "bfloat16", "--reinforce-fused",
                                               "--acer-on-policy", "8", "--device", "cpu"], _check_bench),
    "profile_trainable_bf16": (profile_trainable, SHORT + ["--dtype", "bfloat16"], _check_profile),
    "profile_ab": (profile_ab, ["--seeds", "2", "--games", "8", "--cycles", "1", "--acer-cycles", "1",
                                "--curve-every", "1", "--curve-every-acer", "1", "--eval-games", "8", "--device",
                                "cpu"], _check_ab),
    "debug_dqn": (debug_dqn, ["--platform", "cpu"], _check_session),
    "debug_acer": (debug_acer, ["--device", "cpu"], _check_session),
    "debug_mcts": (debug_mcts, ["--platform", "cpu"], _check_session),
    "debug_gradflow": (debug_gradflow, ["--platform", "cpu"], _check_gradflow),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_main_finishes_on_the_cpu(name, tmp_path):
    module, argv, check = CASES[name]
    if "--out" not in argv and name in ("roofline_cycle", "profile_ab", "debug_gradflow"):
        argv = argv + ["--out", str(tmp_path / "out")]
    check(module.main(argv))
