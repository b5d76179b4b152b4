"""The harness on the CPU at small sizes: a cell added as files alone, the
result line, what the benchmark imports, and ``correct`` coming out false
under the control and under each fault planted beneath the timed path."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import control, harness
from benchmark.common import HERE, ROOT, load_json

SMALL = {"reinforce_h100.train": {"games": 32, "check_block": 32},
         "d3qn_h64.eval_vs_random": {"games": 64, "check_block": 64, "check_pool": 3},
         "reinforce_h100.eval_vs_random_g262144": {"games": 64, "check_block": 64, "check_pool": 3}}


def _run(workload, seed=2**31 + 17, seconds=0.3, overrides=None):
    args = harness.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"])
    return harness.run_cell(load_json(ROOT / "BENCHMARK.json"), args, "cpu",
                            overrides=overrides or SMALL[workload])


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_cell_runs_correct_with_its_end_to_end_metrics(workload):
    result = _run(workload)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"env_steps_per_s", "step_ms_p95", "setup_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in result["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    json.dumps(result)


class _Ledger:
    """A cell that only notes the order of its calls and reads."""

    def __init__(self):
        self.events = []

    def step(self, i):
        self.events.append(("step", i))
        return i

    def read(self, handle):
        self.events.append(("read", handle))


@pytest.mark.parametrize("in_flight", [1, 2, 3])
def test_the_window_sends_ahead_and_reads_every_step_it_sent(in_flight):
    import contextlib

    import torch

    cell = _Ledger()
    window = harness.measure(cell, 5, lambda name: contextlib.nullcontext(), harness.Reader(torch.device("cpu")),
                             in_flight, steps=6)
    sent = [i for kind, i in cell.events if kind == "step"]
    read = [i for kind, i in cell.events if kind == "read"]
    assert sent == read == list(range(5, 11))
    for i in sent:  # step i is read only after step i + in_flight - 1 was sent
        later = min(i + in_flight - 1, 10)
        assert cell.events.index(("step", later)) < cell.events.index(("read", i))
    assert cell.events[-in_flight:] == [("read", i) for i in range(11 - in_flight, 11)]
    assert window.steps == len(window.dispatch_s) == 6
    assert window.seconds == pytest.approx(sum(window.step_s))


def test_the_launch_queues_are_deepened_before_cuda_starts(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.delenv("CUDA_SCALE_LAUNCH_QUEUES", raising=False)
    assert harness.main(["--workload", "reinforce_h100.train", "--seed", "1", "--seconds", "1", "--trace", "0"]) == 2
    assert os.environ["CUDA_SCALE_LAUNCH_QUEUES"] == "4x"


def test_no_card_means_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert harness.main(["--workload", "reinforce_h100.train", "--seed", "1", "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_alone_in_a_directory_exits_without_result(tmp_path):
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    cmd = load_json(ROOT / "BENCHMARK.json")["command"]
    p = subprocess.run([sys.executable, *cmd[1:], "--workload", "reinforce_h100.train", "--seed", "5",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A new configuration, traffic mix and metric of each kind: new files and
    new entries of BENCHMARK.json, no file of the harness edited."""
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "rl6nimmt_torch", tmp_path / "rl6nimmt_torch")
    bench = load_json(ROOT / "BENCHMARK.json")
    config = load_json(HERE / "configs" / "reinforce_h100.json")
    config["net"]["hidden_sizes"] = [32]
    (tmp_path / "benchmark" / "configs" / "policy_h32.json").write_text(json.dumps(config))
    traffic = {**load_json(HERE / "traffic" / "eval_vs_random.json"), "games": 48, "check_block": 48,
               "check_pool": 2}
    (tmp_path / "benchmark" / "traffic" / "duel_small.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark" / "metrics" / "matches_per_s.py").write_text(
        "def read(run):\n    return run.window.steps / run.window.seconds\n")
    (tmp_path / "benchmark" / "metrics" / "games_per_step.py").write_text(
        "def read(run):\n    return float(run.cell.G)\n")
    bench["configs"].append({"name": "policy_h32", "source": "https://example.org/policy-h32",
                             "file": "benchmark/configs/policy_h32.json", "reduced": [], "why": "a test's net"})
    bench["workloads"].append({"name": "policy_h32.duel_small", "config": "policy_h32", "traffic": "duel_small",
                               "chips": 1, "why": "a test's cell"})
    bench["end_to_end"].append({"name": "matches_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["policy_h32.duel_small"]})
    bench["per_layer"].append({"name": "games_per_step", "unit": "games", "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "matches_per_s", "workloads": ["policy_h32.duel_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from benchmark import harness\n"
        "from benchmark.common import ROOT, load_json\n"
        "bench = load_json(ROOT / 'BENCHMARK.json')\n"
        "args = harness.parse(['--workload', 'policy_h32.duel_small', '--seed', '3', '--seconds', '0.2', '--trace', '0'])\n"
        "r = harness.run_cell(bench, args, 'cpu')\n"
        "wl = harness.find_cell(bench, 'policy_h32.duel_small')[0]\n"
        "print(json.dumps({'result': r, 'per_layer': [m['name'] for m in harness.metrics_of(bench, wl, True)],\n"
        "                  'root': str(ROOT)}))\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["root"] == str(tmp_path)
    assert out["result"]["correct"] is True
    assert set(out["result"]["metrics"]) == {"env_steps_per_s", "step_ms_p95", "setup_s", "matches_per_s"}
    assert out["per_layer"] == ["games_per_step"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_and_the_reference_imports_no_program():
    for path in HERE.rglob("*.py"):
        if "tests" in path.relative_to(HERE).parts:
            continue
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops)
        if "reference" in path.relative_to(HERE).parts:
            assert "rl6nimmt_torch" not in tops, path
            assert all(top in {"torch", "__future__", "dataclasses", "math"} for top in tops), (path, tops)


def test_a_run_leaves_no_forbidden_module_loaded():
    script = ("import sys\n"
              f"sys.path.insert(0, {str(ROOT)!r})\n"
              "from benchmark import harness\n"
              "from benchmark.common import ROOT, load_json\n"
              "args = harness.parse(['--workload', 'd3qn_h64.eval_vs_random', '--seed', '4', '--seconds', '0.1',"
              " '--trace', '0'])\n"
              "harness.run_cell(load_json(ROOT / 'BENCHMARK.json'), args, 'cpu', overrides={'games': 32,"
              " 'check_block': 32, 'check_pool': 1})\n"
              "print(harness.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


FAULTS = [(w, f) for w in sorted(SMALL) for f in ("frozen", "half", "token")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(workload, fault):
    from benchmark.faults import planted

    traffic = harness.find_cell(load_json(ROOT / "BENCHMARK.json"), workload)[2]
    with planted(traffic["entry"], fault):
        result = _run(workload, seed=2**31 + 29)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload,games", [("reinforce_h100.train", 256), ("d3qn_h64.eval_vs_random", 2048),
                                            ("reinforce_h100.eval_vs_random_g262144", 16384)])
def test_the_lower_precision_control_is_incorrect(workload, games):
    bench = load_json(ROOT / "BENCHMARK.json")
    reading = control.readings(bench, workload, 2**31 + 41, "bfloat16", "cpu", 0 if "train" in workload else 3,
                               {"games": games, "check_block": games})
    _, _, traffic = harness.find_cell(bench, workload)
    limits = harness.entry_module(traffic).LIMITS
    assert any(reading["checks"][k] > limits[k] for k in reading["checks"]), reading["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cmd = load_json(ROOT / "BENCHMARK.json")["command"]
    p = subprocess.run([sys.executable, *cmd[1:], "--workload", workload, "--seed", str(2**31 + 3), "--seconds", "2",
                        "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["busy_s"] > 0
