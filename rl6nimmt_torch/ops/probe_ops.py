"""K7: the act kernel's building blocks (port of ``experiments/probe_pallas_ops.py``).

One wrapper and one plain twin per probe body (``csrc/probe_ops.cu``):

* ``dot_lhs_t(c, w)``          k1: ``c[F, N]^T @ w[F, 64] -> [N, 64]`` (feature-major input);
* ``transpose_2d(x)``          k2: int32 ``[R, C] -> [C, R]``;
* ``argmax_rows(x)``           k3: f32 ``[N, A] -> int32[N, 1]``, first maximum;
* ``reshape_rows(x, rows)``    k4: int32 ``[n] -> [rows, n // rows]``;
* ``transpose_3d(x)``          k5: f32 ``[F, S, L] -> [S*L, F]`` (``transpose(1, 2, 0)``);
* ``dot_3d(s, w)``             k6: ``s[F, S, L] x w[F, 64]`` over ``F`` -> ``[S, L, 64]``;
* ``dot_mask_argmax(h, wa, hand)`` k7: ``argmax_a where(a == hand, h @ wa, -1e9)``,
  ``h[S, L, 64]``, ``wa[64, A]``, ``hand`` int32 ``[S, L]`` -> int32 ``[S, L]``.

On CUDA tensors each wrapper launches its kernel through the library's launch
route (``_build.Launcher``) and counts it in ``_build.LAUNCHES["probe_k<i>"]``;
on CPU tensors it runs the ``*_plain`` twin,
which spells out the body's arithmetic (an ordered sum over ``F``, an index
gather, a first-maximum scan) rather than calling the one PyTorch op that
computes the same function.
"""

from __future__ import annotations

import torch

from . import _build

DOT_K = 64        # the dot probes' weight width (csrc/probe_ops.cu DOT_K)
MASKED = -1e9     # k7's value for every column but the hand's


_PROBE = {k: _build.Launcher(f"rl6_probe_{k}", f"probe_{k}") for k in _build.PROBES}


def _check(name: str, specs) -> int:
    """Raise unless each ``(arg, tensor, ndim, dtype)`` matches and all share
    one device; return the card's index, or -1 for the CPU."""
    dev = specs[0][1].device
    for arg, x, ndim, dtype in specs:
        if x.dim() != ndim:
            raise ValueError(f"{name}: {arg} must have {ndim} dims, got shape {tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if x.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev}, {arg} is on {x.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return -1 if dev.type == "cpu" else dev.index


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """First index of the maximum along the last axis (int64)."""
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == x.max(dim=-1, keepdim=True).values, idx, x.shape[-1]).min(dim=-1).values


def _transpose_gather(x: torch.Tensor) -> torch.Tensor:
    """``x[R, C] -> [C, R]`` as a gather: ``out[i, j] = flat[j * C + i]``."""
    R, C = x.shape
    idx = torch.arange(R, device=x.device) * C + torch.arange(C, device=x.device)[:, None]
    return x.reshape(-1)[idx]


# ------------------------------------------------------------------ k1 / k6


def dot_lhs_t_plain(c, w):
    """``sum_f c[f, :, None] * w[f]``, one term of ``f`` at a time."""
    out = torch.zeros((c.shape[1], w.shape[1]), dtype=torch.float32, device=c.device)
    for f in range(c.shape[0]):
        out += c[f, :, None] * w[f]
    return out


def _check_dot(name, c, ndim, w) -> int:
    index = _check(name, [("lhs", c, ndim, torch.float32), ("w", w, 2, torch.float32)])
    if w.shape != (c.shape[0], DOT_K):
        raise ValueError(f"{name}: w must be [{c.shape[0]}, {DOT_K}], got {tuple(w.shape)}")
    return index


def dot_lhs_t(c, w):
    index = _check_dot("probe_k1", c, 2, w)
    if index < 0:
        return dot_lhs_t_plain(c, w)
    F, N = c.shape
    out = c.new_empty((N, DOT_K))
    _PROBE["k1"](index, c.data_ptr(), w.data_ptr(), out.data_ptr(), F, N)
    return out


def dot_3d_plain(s, w):
    F, S, L = s.shape
    return dot_lhs_t_plain(s.reshape(F, S * L), w).reshape(S, L, DOT_K)


def dot_3d(s, w):
    index = _check_dot("probe_k6", s, 3, w)
    if index < 0:
        return dot_3d_plain(s, w)
    F, S, L = s.shape
    out = s.new_empty((S, L, DOT_K))
    _PROBE["k6"](index, s.data_ptr(), w.data_ptr(), out.data_ptr(), F, S * L)
    return out


# ------------------------------------------------------------- k2 / k4 / k5


def transpose_2d_plain(x):
    return _transpose_gather(x)


def transpose_2d(x):
    index = _check("probe_k2", [("x", x, 2, torch.int32)])
    if index < 0:
        return transpose_2d_plain(x)
    R, C = x.shape
    out = x.new_empty((C, R))
    _PROBE["k2"](index, x.data_ptr(), out.data_ptr(), R, C)
    return out


def reshape_rows_plain(x, rows: int):
    out = x.new_empty((rows, x.shape[0] // rows))
    out.view(-1).copy_(x)
    return out


def reshape_rows(x, rows: int):
    index = _check("probe_k4", [("x", x, 1, torch.int32)])
    if rows <= 0 or x.shape[0] % rows:
        raise ValueError(f"probe_k4: {x.shape[0]} elements do not split into {rows} rows")
    if index < 0:
        return reshape_rows_plain(x, rows)
    out = x.new_empty((rows, x.shape[0] // rows))
    _PROBE["k4"](index, x.data_ptr(), out.data_ptr(), x.shape[0])
    return out


def transpose_3d_plain(x):
    F, S, L = x.shape
    return _transpose_gather(x.reshape(F, S * L))


def transpose_3d(x):
    index = _check("probe_k5", [("x", x, 3, torch.float32)])
    if index < 0:
        return transpose_3d_plain(x)
    F, S, L = x.shape
    out = x.new_empty((S * L, F))
    _PROBE["k5"](index, x.data_ptr(), out.data_ptr(), F, S * L)
    return out


# ------------------------------------------------------------------ k3 / k7


def argmax_rows_plain(x):
    return _first_argmax(x)[:, None].to(torch.int32)


def argmax_rows(x):
    index = _check("probe_k3", [("x", x, 2, torch.float32)])
    if index < 0:
        return argmax_rows_plain(x)
    N, A = x.shape
    out = x.new_empty((N, 1), dtype=torch.int32)
    _PROBE["k3"](index, x.data_ptr(), out.data_ptr(), N, A)
    return out


def dot_mask_argmax_plain(h, wa, hand):
    adv = h @ wa
    cols = torch.arange(wa.shape[1], device=h.device)
    return _first_argmax(torch.where(cols == hand[..., None], adv, MASKED)).to(torch.int32)


def dot_mask_argmax(h, wa, hand):
    index = _check("probe_k7", [("h", h, 3, torch.float32), ("wa", wa, 2, torch.float32),
                                ("hand", hand, 2, torch.int32)])
    if h.shape[2] != DOT_K or wa.shape[0] != DOT_K or hand.shape != h.shape[:2]:
        raise ValueError(f"probe_k7: need h [S, L, {DOT_K}], wa [{DOT_K}, A], hand [S, L]; got "
                         f"{tuple(h.shape)}, {tuple(wa.shape)}, {tuple(hand.shape)}")
    if index < 0:
        return dot_mask_argmax_plain(h, wa, hand)
    S, L, _ = h.shape
    out = hand.new_empty((S, L))
    _PROBE["k7"](index, h.data_ptr(), wa.data_ptr(), hand.data_ptr(), out.data_ptr(), S * L, wa.shape[1])
    return out
