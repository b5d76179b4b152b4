"""Per-call and device times of K1 (both layouts), K2, K3 and K7's bodies beside their yardsticks.

    python rl6nimmt_torch/experiments/kernel_times.py [--root DIR] [KERNEL ...]

Times the kernels of the ``rl6nimmt_torch`` package found under ``--root``
(by default the tree this file belongs to), so that one run on a card can time
two trees, a parent and a change, with the same code, in turns.  KERNEL names
the rows to time (``resolve_turn``, ``resolve_turn_t``, ``deal_games``,
``play_random_games``, ``probe_k1`` ... ``probe_k7``; all of them by default),
so a tree that lacks an entry is timed on the others.  Per kernel it prints one
JSON line with

* ``ms``: the time of one call as its caller sees it -- CUDA events around
  back-to-back calls, so the host's launch route is in it (the median of five
  runs of 200 calls); for K1-K3 also ``host_us``, the host's microseconds a call;
* ``device_ms``: the kernel's own time per launch -- the ``torch.profiler``
  kernel events of the same calls whose name holds the kernel's (see
  :func:`device_ms`); for K2 and K3 also ``device_ms_g16384``, the same at
  4x the games (512 blocks), which barely moves if one game's chain sets the
  time;
* for K7, ``library_ms`` and ``library_device_ms``: the same two measures of
  its yardstick, the one PyTorch call that computes the same function (every
  device event of the yardstick's calls, per call).

K1 runs at the main path's shapes (P=4, G=4096, the board after five random
turns of seed 1), K2 and K3 at P=4 and G=4096, K7 at the probe script's.  Last
it prints the host's microseconds a call of the two ways to read the current
CUDA stream's handle (the launch route uses the cheaper).  Needs a card; imports nothing of the
package at module level, so ``chip_smoke.py`` shares its helpers.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

G = 4096
G_WIDE = 16_384      # K2 and K3 also at 4x the games
K1_TURN = 5          # the board K1 is timed on: after this many turns
ITERS = 200
REPS = 5             # per-call times: the median of this many runs of ITERS calls
KERNELS = ("resolve_turn", "resolve_turn_t", "deal_games", "play_random_games",
           *(f"probe_k{i}" for i in range(1, 8)))
LAUNCH_ROUTE = ("resolve_turn", "resolve_turn_t", "deal_games", "play_random_games")  # rows with host_us


def cuda_ms(fn, iters: int, reps: int = 1) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``iters`` back-to-back
    calls, after one call of warm-up; the median of ``reps`` such runs."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def device_ms(fn, iters: int, kernel: str | None = None) -> float:
    """Device milliseconds per call of ``fn``, from the device events of
    ``iters`` calls under ``torch.profiler``: the events whose name holds
    ``kernel``, or every device event when ``kernel`` is None (a yardstick
    that may launch several).  The tracer may drop some events of a run (seen
    on the card), so each kernel counts as its mean event time times its
    events a call, ``ceil(events kept / iters)``: exact while fewer than half
    of a kernel's events are dropped."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count and (kernel is None or kernel in e.key)]
    total_us = sum(e.self_device_time_total / e.count * math.ceil(e.count / iters) for e in events)
    if total_us <= 0:
        raise AssertionError(f"no device time traced for {kernel or 'the yardstick'}")
    return total_us / 1e3


def yardsticks(inp: dict) -> dict:
    """K7's yardsticks: the one PyTorch call per probe that computes the same
    function on the same inputs (``None`` where there is none).  Each returns
    a fresh contiguous tensor: :func:`check_yardsticks` refuses a view."""
    return {"k1": lambda: inp["C"].t() @ inp["W1"], "k2": lambda: inp["hands"].t().contiguous(),
            "k3": lambda: torch.argmax(inp["H"], dim=1), "k4": lambda: inp["flat"].reshape(8, 128).clone(),
            "k5": lambda: inp["S"].permute(1, 2, 0).reshape(1024, 47).contiguous(),
            "k6": lambda: torch.einsum("fsl,fh->slh", inp["S2"], inp["W1b"]), "k7": None}


def check_yardsticks(inp: dict, library: dict) -> None:
    """Raise if a yardstick returns a non-contiguous tensor or one that shares
    storage with an input: such a call moves no bytes and times nothing."""
    storages = {x.untyped_storage().data_ptr() for x in inp.values()}
    for key, fn in library.items():
        if fn is None:
            continue
        out = fn()
        if not out.is_contiguous() or out.untyped_storage().data_ptr() in storages:
            raise AssertionError(f"K7 {key}'s yardstick returns a view of its input")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: n/a"


def stream_api_us(index: int, n: int = 20_000) -> dict:
    """Host microseconds per call of the two ways to read the current stream's handle."""
    raw = torch._C._cuda_getCurrentRawStream
    apis = {"torch.cuda.current_stream(i).cuda_stream": lambda: torch.cuda.current_stream(index).cuda_stream,
            "torch._C._cuda_getCurrentRawStream(i)": lambda: raw(index)}
    out = {}
    for name, fn in apis.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
    return out


def host_us(fn, n: int = 5_000) -> float:
    """Host microseconds per call of ``fn`` over ``n`` calls, after a warm-up."""
    for _ in range(100):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    out = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return out


def _import_package(root: Path):
    """``rl6nimmt_torch`` from ``root``, refusing one imported from elsewhere."""
    sys.path.insert(0, str(root))
    import rl6nimmt_torch

    where = Path(rl6nimmt_torch.__file__).resolve().parents[1]
    if where != root.resolve():
        raise SystemExit(f"rl6nimmt_torch comes from {where}, not {root}: run this file by its path")
    return rl6nimmt_torch


def run(root: Path, only=()) -> list:
    """Time K1-K3 and K7 of the package under ``root`` (the rows named in
    ``only``, or all); print and return the rows."""
    _import_package(root)
    from rl6nimmt_torch.engine import EnvConfig, deal, step
    from rl6nimmt_torch.experiments import probe_ops as probe_exp
    from rl6nimmt_torch.ops import step_kernel
    from rl6nimmt_torch.ops.game_kernel import deal_games, play_random_games, random_pick_words, random_picks

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi_line()
    cfg = EnvConfig(4)
    R, T = cfg.num_rows, cfg.threshold
    state = deal(cfg, 1, G, device=dev)
    words = random_pick_words(cfg, 1, G, dev)
    for t in range(K1_TURN):
        state, _ = step(cfg, state, random_picks(state.hands_sorted, words[t]))
    acts = random_picks(state.hands_sorted, words[K1_TURN]).contiguous()
    board, row_len = state.board, state.row_len
    board_t, len_t = board.reshape(G, R * T).T.contiguous(), row_len.T.contiguous()

    # name -> (call, its kernel's profiler name, yardstick or None)
    timed = {"resolve_turn": (lambda: step_kernel.resolve_turn(cfg, board, row_len, acts), "resolve_turn_kernel", None),
             "resolve_turn_t": (lambda: step_kernel.resolve_turn_t(cfg, board_t, len_t, acts), "resolve_turn_kernel",
                                None),
             "deal_games": (lambda: deal_games(cfg, 5, G, device=dev), "deal_games_kernel", None),
             "play_random_games": (lambda: play_random_games(cfg, 6, G, device=dev), "play_random_games_kernel",
                                   None)}
    wide = {"deal_games": lambda: deal_games(cfg, 5, G_WIDE, device=dev),
            "play_random_games": lambda: play_random_games(cfg, 6, G_WIDE, device=dev)}
    inp = probe_exp.probe_inputs(dev)
    library = yardsticks(inp)
    check_yardsticks(inp, library)
    for key, _, kernel, _, args, _ in probe_exp.probes(inp):
        timed[f"probe_{key}"] = (lambda kernel=kernel, args=args: kernel(*args), f"probe_{key}_kernel", library[key])
    timed = {k: v for k, v in timed.items() if not only or k in only}
    # Every per-call time first: no profiler session has run in this process yet.
    rows = []
    for name, (fn, _, lib) in timed.items():
        row = {"kernel": name, "ms": cuda_ms(fn, ITERS, REPS)}
        if name in LAUNCH_ROUTE:
            row["host_us"] = host_us(fn)
        else:
            row["library_ms"] = cuda_ms(lib, ITERS, REPS) if lib else None
        rows.append(row)
    for row in rows:
        fn, kernel, lib = timed[row["kernel"]]
        row["device_ms"] = device_ms(fn, ITERS, kernel)
        if row["kernel"] in wide:
            row[f"device_ms_g{G_WIDE}"] = device_ms(wide[row["kernel"]], ITERS // 4, kernel)
        if "library_ms" in row:
            row["library_device_ms"] = device_ms(lib, ITERS) if lib else None
        row.update(root=str(root), card=card)
        print(json.dumps(row), flush=True)
    print(json.dumps({"stream_api_us": stream_api_us(dev.index or 0), "root": str(root), "card": card}),
          flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="directory holding the rl6nimmt_torch package to time")
    ap.add_argument("kernels", nargs="*", help="rows to time (default: all)")
    args = ap.parse_args(argv)
    if set(args.kernels) - set(KERNELS):
        ap.error(f"unknown kernels {sorted(set(args.kernels) - set(KERNELS))}; choose from {KERNELS}")
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device; these are times on the card", file=sys.stderr)
        return 2
    run(args.root, args.kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
