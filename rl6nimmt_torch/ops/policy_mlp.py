"""The action-in-input policy's forward past the state product, in one kernel.

``policy_logits(shared, cards, w0, w2, b2, w3, b3, den) -> f32[..., S]``:
for each candidate card ``cards[..., s]`` (int, -1 where padded) of a row whose
state product is ``shared[...]`` (``norm(state) @ W1[1:] + b1``, ``f32[..., D]``),

    a     = -1 + 2 * card / den
    h1    = relu(shared + a * w0)          (the first layer's rank-1 action term)
    h2    = relu(h1 @ w2 + b2)
    logit = h2 @ w3 + b3, and NEG_INF where card < 0,

``w2`` being ``[D, D]`` and ``w3`` and ``b3`` the 1-wide head's ``[D, 1]`` and ``[1]``.  On CUDA
tensors it launches ``csrc/policy_mlp.cu`` (counted under ``policy_mlp`` in
``_build.LAUNCHES``), which writes no hidden activation unless autograd needs
it and spends no FLOPs on padded cards; on CPU tensors it runs
:func:`policy_mlp_plain`, the same math in PyTorch ops.  With gradients
enabled it goes through :class:`PolicyMLP`, whose forward also keeps ``h1``
and ``h2`` (what autograd would keep) and whose backward is written in torch
ops.

:func:`fused_weights` is the rule ``agents/reinforce.py``
``action_in_input_logits`` follows to take this route: CUDA tensors, a
float32 ReLU net whose trunk is two linears of one width D, a multiple of 4
and at most 112, one head of width 1, and at most 16 candidates a row.  Every other CUDA call runs the
plain ops and is counted in :data:`FALLBACKS`.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import _build

NEG_INF = -1e9
MAX_WIDTH = 112     # D, both hidden layers' width (a multiple of 4)
MAX_CANDIDATES = 16  # S

_LAUNCH = _build.Launcher("rl6_policy_mlp", "policy_mlp")

# CUDA calls of action_in_input_logits that the kernel does not serve (another
# dtype, activation, depth, width or head): they run the plain ops.
FALLBACKS = {"policy_mlp": 0}


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def fused_weights(spec, params, state: torch.Tensor, cards: torch.Tensor):
    """``(w0, w2, b2, w3, b3)`` of the net when the kernel serves this call of
    the action-in-input forward, else None (the caller runs the plain ops;
    a CUDA call is then counted in :data:`FALLBACKS`)."""
    if not (_on_card(state) and _on_card(cards)):
        return None
    trunk, heads = params["trunk"], params["heads"]
    if (spec.compute_dtype == "float32" and spec.activation == "relu" and len(trunk) == 2 and len(heads) == 1
            and state.dtype == torch.float32 and state.shape[:-1] == cards.shape[:-1]
            and 1 <= cards.shape[-1] <= MAX_CANDIDATES):
        w1, w2, head = trunk[0]["w"], trunk[1]["w"], heads[0]
        D = w2.shape[0]
        if (D <= MAX_WIDTH and D % 4 == 0 and tuple(w2.shape) == (D, D) and w1.shape[-1] == D
                and tuple(head["w"].shape) == (D, 1)
                and all(t.dtype == torch.float32 for t in (w1, w2, trunk[1]["b"], head["w"], head["b"]))):
            return w1[0], w2, trunk[1]["b"], head["w"], head["b"]
    FALLBACKS["policy_mlp"] += 1
    return None


def policy_mlp_plain(shared, cards, w0, w2, b2, w3, b3, den: float, save: bool = False):
    """Plain PyTorch twin of the kernel: ``logits``, or with ``save``
    ``(logits, h1, h2)`` with the padded rows' ``h1`` and ``h2`` zero."""
    a = -1.0 + 2.0 * cards.to(torch.float32) / den
    h1 = torch.relu(shared[..., None, :] + a[..., :, None] * w0)
    h2 = torch.relu(h1 @ w2 + b2)
    live = cards >= 0
    logits = torch.where(live, (h2 @ w3 + b3)[..., 0], NEG_INF)
    if not save:
        return logits
    return logits, torch.where(live[..., None], h1, 0.0), torch.where(live[..., None], h2, 0.0)


def _launch(shared, cards, w0, w2, b2, w3, b3, den: float, save: bool):
    """One launch on ``shared f32[M, D]`` and ``cards int32[M, S]`` (row
    stride free, unit column stride): ``(logits, h1, h2)``, the last two None
    without ``save``."""
    M, S = cards.shape
    D = w2.shape[0]
    logits = shared.new_empty((M, S))
    h1 = shared.new_empty((M, S, D)) if save else None
    h2 = shared.new_empty((M, S, D)) if save else None
    if M:
        _LAUNCH(shared.get_device(), shared.data_ptr(), cards.data_ptr(), cards.stride(0), M, S, D,
                w0.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), float(den),
                logits.data_ptr(), None if h1 is None else h1.data_ptr(), None if h2 is None else h2.data_ptr())
    return logits, h1, h2


def _forward(shared, cards, w0, w2, b2, w3, b3, den: float, save: bool):
    """The kernel on CUDA tensors (after checking them), the twin on CPU ones."""
    if not shared.is_cuda:
        out = policy_mlp_plain(shared, cards, w0, w2, b2, w3, b3, den, save)
        return out if save else (out, None, None)
    D = w2.shape[0]
    if (shared.dim() != 2 or cards.dim() != 2 or shared.shape[0] != cards.shape[0] or tuple(w2.shape) != (D, D)
            or shared.shape[1] != D):
        raise ValueError(f"policy_mlp: shared {tuple(shared.shape)} and cards {tuple(cards.shape)} "
                         f"do not fit W2 {tuple(w2.shape)}")
    if D > MAX_WIDTH or D % 4 or cards.shape[1] > MAX_CANDIDATES:
        raise ValueError(f"policy_mlp: width {D} (a multiple of 4, at most {MAX_WIDTH}) and {cards.shape[1]} "
                         f"candidates (at most {MAX_CANDIDATES})")
    if tuple(w0.shape) != (D,) or tuple(b2.shape) != (D,) or tuple(w3.shape) != (D, 1) or b3.numel() != 1:
        raise ValueError("policy_mlp: w0 [D], b2 [D], w3 [D, 1] and b3 [1] expected")
    tensors = (shared, w0, w2, b2, w3, b3)
    if any(t.dtype != torch.float32 for t in tensors) or any(t.device != shared.device for t in tensors + (cards,)):
        raise TypeError("policy_mlp: float32 weights and activations on one device expected")
    if shared.stride(1) != 1 or shared.stride(0) != D or shared.data_ptr() % 16:
        shared = shared.contiguous() if not shared.is_contiguous() else shared.clone()
    cards = cards.to(torch.int32)
    if cards.stride(1) != 1:
        cards = cards.contiguous()
    return _launch(shared, cards, w0.contiguous(), w2.contiguous(), b2.contiguous(), w3.contiguous(),
                   b3.contiguous(), den, save)


def _relu_backward(grad, out):
    """ReLU's backward as autograd runs it: ``grad`` where ``out`` is positive."""
    return torch.ops.aten.threshold_backward(grad, out, 0)


class PolicyMLP(torch.autograd.Function):
    """The forward with gradients: it keeps ``h1`` and ``h2`` and its backward
    runs the products autograd runs on the plain ops.  The backward lets go of
    each hidden tensor and gradient as soon as it is used, as autograd frees
    the plain ops' saved tensors node by node, so its peak memory is no higher."""

    @staticmethod
    def forward(ctx, shared, cards, w0, w2, b2, w3, b3, den):
        logits, h1, h2 = _forward(shared, cards, w0, w2, b2, w3, b3, den, save=True)
        ctx.den = den
        ctx.save_for_backward(cards, w2, w3)
        ctx.hidden = [h1, h2]   # intermediates, kept off save_for_backward so the backward can free them
        return logits

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        cards, w2, w3 = ctx.saved_tensors
        if ctx.hidden is None:
            raise RuntimeError("policy_mlp: the backward frees the hidden tensors; it runs once (no retain_graph)")
        h1, h2 = ctx.hidden
        ctx.hidden = None
        M, S = cards.shape
        D = w2.shape[0]
        need = ctx.needs_input_grad
        g = torch.where(cards >= 0, g, 0.0).reshape(M * S, 1)
        h1, h2 = h1.reshape(M * S, D), h2.reshape(M * S, D)
        dh2 = _relu_backward(g * w3[:, 0], h2)
        dw3 = h2.T @ g if need[5] else None
        del h2
        dw2 = h1.T @ dh2 if need[3] else None
        db2 = dh2.sum(dim=0) if need[4] else None
        dshared = dw0 = None
        if need[0] or need[2]:
            dh1 = dh2 @ w2.T
            del dh2
            dh1 = _relu_backward(dh1, h1)
            del h1
            dshared = dh1.reshape(M, S, D).sum(dim=1) if need[0] else None
            if need[2]:
                a = (-1.0 + 2.0 * cards.to(torch.float32) / ctx.den).reshape(1, M * S)
                dw0 = (a @ dh1)[0]
        return dshared, None, dw0, dw2, db2, dw3, g.sum().reshape(1) if need[6] else None, None


def policy_logits(shared, cards, w0, w2, b2, w3, b3, den: float):
    """The logits ``f32[..., S]`` of ``cards int[..., S]`` over ``shared
    f32[..., D]`` (the same leading axes): the kernel on CUDA tensors, its
    twin on CPU ones, through :class:`PolicyMLP` when a gradient is needed."""
    lead, S = cards.shape[:-1], cards.shape[-1]
    shared2, cards2 = shared.reshape(-1, shared.shape[-1]), cards.reshape(-1, S)
    args = (shared2, cards2, w0, w2, b2, w3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        logits = PolicyMLP.apply(*args, den)
    else:
        logits = _forward(*args, den, save=False)[0]
    return logits.reshape(lead + (S,))
