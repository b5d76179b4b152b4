"""Philox4x32-10 in plain PyTorch: the one random stream of the port's kernels.

The TPU kernels drew from the TPU hardware PRNG (``pltpu.prng_random_bits``)
and the XLA paths from threefry; neither can be replayed on the GPU.  The
port's kernels (``csrc/game.cuh``) and their plain twins both draw from
Philox4x32-10 (Salmon et al., Random123), so the twins consume the same
words in the same order and K1-K3 equal them bit for bit.

Counter layout (the same in ``csrc/game.cuh``):

* key     = (seed & 0xFFFFFFFF, seed >> 32), ``seed`` an unsigned 64-bit int;
* counter = (game, draw block, stream, 0).

Draw ``i`` of a game's stream is word ``i % 4`` of block ``i // 4``.  The
streams are :data:`STREAM_DEAL` (the partial Fisher-Yates deal) and
:data:`STREAM_PLAY` (K3's uniform-legal picks).  A draw in ``[0, n)`` is the
multiply-high ``(word * n) >> 32``.

Arithmetic is int64 with ``& 0xFFFFFFFF``; each 32x32 product is split into
16-bit limbs so no intermediate exceeds 2**49 (signed int64 overflow is never
relied on).
"""

from __future__ import annotations

import torch

M0 = 0xD2511F53
M1 = 0xCD9E8D57
W0 = 0x9E3779B9
W1 = 0xBB67AE85
MASK32 = 0xFFFFFFFF

STREAM_DEAL = 0
STREAM_PLAY = 1


def _mulhilo(a: torch.Tensor, m: int):
    """``(hi, lo)`` 32-bit halves of ``a * m`` for int64 ``a`` in [0, 2**32)."""
    p0 = a * (m & 0xFFFF)               # < 2**48
    p1 = a * (m >> 16)                  # < 2**48
    s = p0 + ((p1 & 0xFFFF) << 16)      # < 2**49
    return (p1 >> 16) + (s >> 32), s & MASK32


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox4x32 on broadcastable int64 tensors of 32-bit words.

    ``k0``/``k1`` may be Python ints.  Returns the four output words.
    """
    c = [torch.as_tensor(x, dtype=torch.int64) & MASK32 for x in (c0, c1, c2, c3)]
    dev = next((x.device for x in c if x.dim() > 0), c[0].device)
    c = [x.to(dev) for x in c]
    k0 = int(k0) & MASK32
    k1 = int(k1) & MASK32
    for r in range(rounds):
        if r:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(c[0], M0)
        hi1, lo1 = _mulhilo(c[2], M1)
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def philox_words(seed: int, games: torch.Tensor, stream: int, n_words: int) -> torch.Tensor:
    """``int64[G, n_words]``: the first ``n_words`` draws of each game's stream."""
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be an unsigned 64-bit int, got {seed}")
    n_blocks = -(-n_words // 4)
    g = games.to(torch.int64)[:, None]
    blk = torch.arange(n_blocks, dtype=torch.int64, device=g.device)[None, :]
    out = philox4x32(g, blk, stream, 0, seed & MASK32, seed >> 32)
    words = torch.stack(out, dim=-1).reshape(g.shape[0], n_blocks * 4)
    return words[:, :n_words]


def draw_below(words: torch.Tensor, n) -> torch.Tensor:
    """Multiply-high draw in ``[0, n)``: ``(word * n) >> 32`` (int64)."""
    return (words * n) >> 32
