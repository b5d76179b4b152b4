"""Readings that the limits of ``correct`` are set from: the program on many
seeds, and the lower-precision control on a few, each through the cell's own
entry at the cell's own size and compared with the plain reference.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --control-seeds 4,5,6 [--matches 4]
        [--faults half,token]

The control is the program with its nets computing in bfloat16 (the nets'
``compute_dtype``), the nearest precision below the configurations' float32.
Training needs no measured window: its check reads the set-up steps.  An
evaluation plays ``--matches`` matches after its warm-up, as a short window at
the cell's load.  Prints one JSON line a seed and side; the benchmark's own
runs never run this.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

from benchmark import harness  # noqa: E402
from benchmark.common import load_json  # noqa: E402


def readings(bench, workload: str, seed: int, dtype, device, matches: int, overrides=None, fault=None) -> dict:
    """One seed's compared numbers (and notes) for the program (``dtype=None``),
    the control, or the program with ``fault`` planted under its timed path.
    ``workload`` is a cell's name, or ``<config>.<traffic>`` of files that no
    cell uses yet."""
    import contextlib

    import torch

    from benchmark.common import HERE
    from benchmark.faults import planted

    if any(w["name"] == workload for w in bench["workloads"]):
        _, config, traffic = harness.find_cell(bench, workload)
    else:
        name, mix = workload.split(".", 1)
        config, traffic = load_json(HERE / "configs" / f"{name}.json"), load_json(HERE / "traffic" / f"{mix}.json")
    traffic = {**traffic, **({"check_pool": matches} if "check_pool" in traffic and matches else {}),
               **(overrides or {})}
    with planted(traffic["entry"], fault) if fault else contextlib.nullcontext():
        cell = harness.entry_module(traffic).build(config, traffic, seed, torch.device(device), dtype=dtype)
        cell.warm_up()
        for i in range(cell.first_step, cell.first_step + matches):
            cell.read(cell.step(i))
    cell.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks, failed = cell.check()
    side = f"fault:{fault}" if fault else "control" if dtype else "program"
    out = {"workload": workload, "seed": seed, "side": side, "failed": failed,
           "checks": {k: v for k, (v, _) in checks.items()}, "notes": getattr(cell, "notes", {})}
    del cell
    gc.collect()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--matches", type=int, default=4, help="steps after the warm-up (evaluation cells)")
    p.add_argument("--faults", default="", help="faults planted on the program, each run on every --seeds seed")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = load_json(ROOT / "BENCHMARK.json")
    program = [int(s) for s in args.seeds.split(",") if s]
    runs = [(s, None, None) for s in program]
    runs += [(int(s), "bfloat16", None) for s in args.control_seeds.split(",") if s]
    runs += [(s, None, f) for f in args.faults.split(",") if f for s in program]
    results = []
    for seed, dtype, fault in runs:
        r = readings(bench, args.workload, seed, dtype, args.device, args.matches, fault=fault)
        print(json.dumps(r), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
