"""Index helpers (counterparts of ``rl6nimmt_tpu/utils/tpu_ops.py``).

On the TPU these were one-hot sums because gathers lowered to a slow path;
on the GPU a gather is cheap, so only the semantics are kept.
"""

from __future__ import annotations

import numpy as np
import torch


def uniform_index(u: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``floor(u * count)`` clamped to ``count - 1`` (0 where ``count == 0``).

    ``u`` holds one uniform in ``[0, 1)`` per element (injected, so tests can
    hand both frameworks the same draws).  Computed in float32 like the JAX
    version, so equal uniforms give equal indices.
    """
    r = torch.floor(u.float() * count.float()).long()
    return torch.minimum(r, torch.clamp(count.long() - 1, min=0))


def onehot_select(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` along the last axis (``take_along_axis`` semantics)."""
    return torch.gather(x, -1, idx.long().unsqueeze(-1)).squeeze(-1)


# ------------------------------------------------------------- data parallel

# All-reduces made by :func:`pmean_fused` in this process: the count and the
# bytes each rank sent into them.
ALLREDUCES = {"calls": 0, "bytes": 0}


def leaves_with_paths(tree, prefix=()):
    """``[(path, leaf)]`` of a tree of dicts, lists and tuples over tensors (or
    numpy arrays), in tree order; a path is the keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves_with_paths(v, prefix + (str(i),))]
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        return [(prefix, tree)]
    raise TypeError(f"unsupported tree leaf {type(tree).__name__} at {'/'.join(prefix)}")


def tree_rebuild(like, leaves):
    """``like``'s structure over ``leaves`` (in :func:`leaves_with_paths` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def host_staged(group, x: torch.Tensor) -> torch.Tensor:
    """``x`` as a collective of ``group`` takes it: a CUDA tensor goes through
    the host for gloo, which reduces host memory."""
    import torch.distributed as dist

    return x.cpu() if x.is_cuda and dist.get_backend(group) == "gloo" else x


def pmean_fused(tree, group):
    """The mean of a whole tree over the ranks of ``group``, as ONE all-reduce
    (the counterpart of ``tpu_ops.pmean_fused``).

    Every leaf goes into one contiguous float32 buffer, which one
    ``dist.all_reduce(SUM)`` sums; each rank then divides by the ranks summed
    and unflattens.  One collective an update instead of one a leaf (a noisy
    dueling net has 12 leaves, a DQN cycle 8 updates).  ``group`` is a process
    group, or a tuple of them reduced in turn (a 2-level mesh: inside the
    slice, then across slices); ``None`` returns ``tree`` itself.  Every rank
    holds the same sum after the reduce and divides it the same way, so the
    result is bit-identical across ranks; over one rank it equals ``tree`` bit
    for bit.  A gloo group stages a CUDA buffer through the host.
    """
    if group is None:
        return tree
    import torch.distributed as dist

    groups = tuple(group) if isinstance(group, (list, tuple)) else (group,)
    leaves = [x for _, x in leaves_with_paths(tree)]
    if any(x.dtype != torch.float32 for x in leaves):
        raise TypeError("pmean_fused reduces float32 leaves only")
    flat = torch.cat([x.detach().reshape(-1) for x in leaves])
    ranks = 1
    for g in groups:
        staged = host_staged(g, flat)
        dist.all_reduce(staged, op=dist.ReduceOp.SUM, group=g)
        flat = staged.to(flat.device)
        ranks *= dist.get_world_size(g)
        ALLREDUCES["calls"] += 1
        ALLREDUCES["bytes"] += flat.numel() * flat.element_size()
    flat = flat / ranks
    out, start = [], 0
    for x in leaves:
        out.append(flat[start:start + x.numel()].view(x.shape))
        start += x.numel()
    return tree_rebuild(tree, out)
