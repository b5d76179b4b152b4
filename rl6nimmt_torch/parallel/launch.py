"""Spawn ranks of one ``torch.distributed`` world on this machine.

``spawn(fn, world_size, *args)`` starts ``world_size`` processes (the
``spawn`` start method, so each imports only what ``fn``'s module imports),
initializes the default process group in each (``backend`` gloo or nccl,
rendezvous through a file in a fresh temporary directory, one CPU thread a
rank), calls ``fn(rank, world_size, *args)`` and returns the ranks' results in
rank order.  A rank
that fails stops the others and raises here with its traceback.  ``fn`` must
be importable by name (a module-level function).

:func:`init_from_env` joins a world whose ranks were started elsewhere
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, as
``torchrun`` sets them).  Neither switches backend or device: NCCL without a
card, or with more ranks than cards, raises.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def check_backend(backend: str, world_size: int) -> None:
    """Raise if ``backend`` cannot run ``world_size`` ranks here."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a CUDA device; use 'gloo' on the CPU")
        if world_size > torch.cuda.device_count():
            raise RuntimeError(f"NCCL needs one card a rank: {world_size} ranks, "
                               f"{torch.cuda.device_count()} cards (use 'gloo' to share a card)")


def _rank_main(fn, rank, world_size, backend, init_method, out_dir, args):
    torch.set_num_threads(1)
    out = Path(out_dir)
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
        result = ("ok", fn(rank, world_size, *args))
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(out / f"rank{rank}.tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out / f"rank{rank}.tmp", out / f"rank{rank}.pickle")
    if result[0] == "ok":
        # A rank that leaves closes its connections at once, and a peer still
        # finishing the last collective then fails: leave only when every rank
        # has written its result (a failed rank leaves at once, which frees
        # peers blocked on it).
        deadline = time.monotonic() + 120
        while (not all((out / f"rank{r}.pickle").exists() for r in range(world_size))
               and time.monotonic() < deadline):
            time.sleep(0.02)
        dist.destroy_process_group()


def spawn(fn, world_size: int, *args, backend: str = "gloo", timeout: float = 600.0):
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` new ranks; their results in rank order."""
    check_backend(backend, world_size)
    out_dir = tempfile.mkdtemp(prefix="rl6dp-")
    init = f"file://{os.path.join(out_dir, 'rendezvous')}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, init, out_dir, args))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        results, errors = [None] * world_size, {}
        pending = set(range(world_size))
        while pending:
            for r in sorted(pending):
                path = Path(out_dir) / f"rank{r}.pickle"
                if path.exists():
                    with open(path, "rb") as f:
                        status, value = pickle.load(f)
                    if status == "ok":
                        results[r] = value
                    else:
                        errors[r] = value
                    pending.discard(r)
                elif not procs[r].is_alive() and not path.exists():
                    errors[r] = f"exited with code {procs[r].exitcode}"
                    pending.discard(r)
            if pending and time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(pending)} of {world_size} did not finish in {timeout} s"
                                   + "".join(f"\nrank {r}: {e}" for r, e in errors.items()))
            if pending:
                time.sleep(0.02)
        if errors:
            # A rank that fails closes its connections, and its peers then fail
            # in their collectives: list the ranks whose error is their own first.
            order = sorted(errors, key=lambda r: ("Connection closed" in errors[r], r))
            raise RuntimeError(f"{len(errors)} of {world_size} ranks failed:"
                               + "".join(f"\n--- rank {r} ---\n{errors[r]}" for r in order))
        for p in procs:
            p.join(timeout=30)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(out_dir, ignore_errors=True)


def init_from_env(backend: str = "gloo") -> tuple:
    """Join the world described by ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
    ``MASTER_PORT``; returns ``(rank, world_size)``."""
    rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    check_backend(backend, world_size)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world_size)
    return rank, world_size
