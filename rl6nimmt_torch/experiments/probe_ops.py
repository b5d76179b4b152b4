"""Check the act kernel's building blocks (K7) against their plain twins.

    python -m rl6nimmt_torch.experiments.probe_ops

The port of ``experiments/probe_pallas_ops.py``'s ``main`` and ``main2``: the
same seven probes on the same inputs (``np.random.default_rng(0)`` for k1-k5,
``default_rng(1)`` for k6-k7, drawn in the JAX script's order).  Each probe
runs its kernel (``ops/probe_ops.py``) and prints ``OK`` or ``FAIL`` with
``max|diff|`` against its twin for the dots and ``exact`` for the rest; any
failure makes the exit code 1.  On ``device="cpu"`` the wrappers run the twins.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import probe_ops as ops
from ..utils.device import resolve_device

RTOL, ATOL = 1e-5, 1e-6   # atol scales with the largest magnitude (PARITY_TORCH.md section 7)


def probe_inputs(device="cuda") -> dict:
    """The JAX script's arrays as tensors on ``device``."""
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)    # noqa: E731
    rng = np.random.default_rng(0)
    inp = {"C": f32(rng.normal(size=(47, 128))), "W1": f32(rng.normal(size=(47, 64))),
           "H": f32(rng.normal(size=(128, 104))), "hands": i32(rng.integers(0, 104, size=(16, 128))),
           "flat": i32(rng.integers(0, 104, size=(1024,))), "S": f32(rng.normal(size=(47, 8, 128)))}
    rng = np.random.default_rng(1)
    inp.update(S2=f32(rng.normal(size=(47, 8, 128))), W1b=f32(rng.normal(size=(47, 64))),
               Wa=f32(rng.normal(size=(64, 104))), hand=i32(rng.integers(0, 104, size=(8, 128))),
               H3=f32(rng.normal(size=(8, 128, 64))))
    return inp


K7_EDGE_ROWS = 1_027    # rows of k7_edge_inputs: eight blocks of 128 and a ragged three


def k7_edge_inputs(A: int, device="cuda", misaligned: bool = False, seed: int = 5):
    """``(h [1, N, 64], wa [64, A], hand [1, N])`` that pin k7's rule at its edges.

    Random rows (``default_rng(seed)``) plus rows whose hand lies outside
    ``[0, A)`` (-1, ``A``, ``A + 7``) and rows whose masked value ``v = h .
    wa[:, hand]`` is exactly -1e9, the floats just below and above it, and NaN,
    made through the hand's column of ``wa``: zero but for its first weight,
    with ``h``'s first entry 1, so every summation order gives the same ``v``.
    At ``A > 1`` column 0 holds -2e9 (a hand of 0 whose ``v`` is below -1e9).
    ``misaligned`` puts ``h`` 4 bytes past a 16-byte boundary."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    N = K7_EDGE_ROWS
    h = rng.normal(size=(N, ops.DOT_K)).astype(np.float32)
    wa = rng.normal(size=(ops.DOT_K, A)).astype(np.float32)
    hand = rng.integers(0, A, size=N).astype(np.int32)
    hand[:3] = (-1, A, A + 7)
    at = np.float32(-1e9)
    values = {0: np.float32(-2e9), 1: at, 2: np.nextafter(at, np.float32(-np.inf)),
              3: np.nextafter(at, np.float32(0)), 4: np.float32(np.nan)}
    for row, (col, v) in enumerate((c, v) for c, v in values.items() if c < A):
        wa[:, col] = 0.0
        wa[0, col] = v
        hand[3 + row] = col
        h[3 + row, 0] = 1.0
    flat = torch.empty(N * ops.DOT_K + 4, dtype=torch.float32, device=dev)
    start = 1 if misaligned else 0
    h_t = flat[start:start + N * ops.DOT_K].view(1, N, ops.DOT_K)
    h_t.copy_(torch.as_tensor(h, device=dev)[None])
    return h_t, torch.as_tensor(wa, device=dev), torch.as_tensor(hand, device=dev)[None]


def probes(inp: dict):
    """``(key, label, kernel, twin, args, exact)`` for k1-k7."""
    return [
        ("k1", "dotT [47,128]x[47,64]", ops.dot_lhs_t, ops.dot_lhs_t_plain, (inp["C"], inp["W1"]), False),
        ("k2", "transpose [16,128]->[128,16]", ops.transpose_2d, ops.transpose_2d_plain, (inp["hands"],), True),
        ("k3", "argmax [128,104] lanes", ops.argmax_rows, ops.argmax_rows_plain, (inp["H"],), True),
        ("k4", "reshape [1024]->[8,128]", ops.reshape_rows, ops.reshape_rows_plain, (inp["flat"], 8), True),
        ("k5", "transpose3d [47,8,128]->[1024,47]", ops.transpose_3d, ops.transpose_3d_plain, (inp["S"],), True),
        ("k6", "dot3d [47,8,128]x[47,64]", ops.dot_3d, ops.dot_3d_plain, (inp["S2"], inp["W1b"]), False),
        ("k7", "dot3d2+mask+argmax ax2", ops.dot_mask_argmax, ops.dot_mask_argmax_plain,
         (inp["H3"], inp["Wa"], inp["hand"]), True),
    ]


def compare(got: torch.Tensor, want: torch.Tensor, exact: bool):
    """``(ok, max|diff|)``: equal for exact probes, else within RTOL/ATOL."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    diff = float((got.double() - want.double()).abs().max())
    if exact:
        return torch.equal(got, want), diff
    scale = max(1.0, float(want.abs().max()))
    return bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL * scale)), diff


def run(device="cuda") -> list:
    """Run every probe once against its twin; print and return the results."""
    results = []
    for key, label, kernel, twin, args, exact in probes(probe_inputs(device)):
        ok, diff = compare(kernel(*args), twin(*args), exact)
        detail = f"exact: {ok}" if exact else f"max|diff| vs twin: {diff:.3e}"
        print(f"  {key} {label}: {'OK' if ok else 'FAIL'} ({detail})", flush=True)
        results.append({"probe": key, "label": label, "ok": ok, "max_abs_err": diff})
    return results


def main() -> int:
    return 0 if all(r["ok"] for r in run()) else 1


if __name__ == "__main__":
    sys.exit(main())
