"""Checkpoint / resume (port of ``utils/checkpoint.py``).

* :func:`save_checkpoint` / :func:`load_checkpoint` pickle any object (a
  tournament, agents, parameter trees) atomically (a temporary file in the
  target's directory, then ``os.replace``); tensors pickle with their device,
  so a checkpoint of agents on the card loads on a card;
* :func:`save_params` / :func:`load_params` store a bare parameter tree as a
  flat npz whose keys are the tree paths (``trunk/0/w``), the JAX package's
  names, so an npz either package saved loads into the other (no pickle on
  the load path);
* :func:`save_params_orbax` / :func:`load_params_orbax` keep the JAX names
  with ``torch.save`` in place of Orbax, which has no PyTorch counterpart
  here: the checkpoint is a directory holding ``params.pt``, overwritten
  atomically, loaded with ``weights_only=True`` (``PARITY_TORCH.md`` §17).

A tree is dicts, lists and tuples over tensors (or numpy arrays); loading
into ``like`` gives each leaf ``like``'s dtype and device.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any

import numpy as np
import torch

from .ops import leaves_with_paths, tree_rebuild

ORBAX_FILE = "params.pt"


def save_checkpoint(path: str, payload: Any) -> None:
    """Atomically pickle ``payload`` to ``path``."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def _like(arr: np.ndarray, leaf, name: str):
    if tuple(arr.shape) != tuple(leaf.shape):
        raise ValueError(f"{name}: saved shape {tuple(arr.shape)}, expected {tuple(leaf.shape)}")
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(arr).to(dtype=leaf.dtype, device=leaf.device)
    return np.asarray(arr, dtype=leaf.dtype)


def _host(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save_params(path: str, params: Any) -> None:
    """Save a parameter tree as flat npz (keys = tree paths)."""
    flat = {"/".join(p): _host(leaf) for p, leaf in leaves_with_paths(params)}
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_params(path: str, like: Any) -> Any:
    """Load an npz written by :func:`save_params` (either package's) into the structure of ``like``."""
    with np.load(path) as data:
        leaves = [_like(data["/".join(p)], leaf, "/".join(p)) for p, leaf in leaves_with_paths(like)]
    return tree_rebuild(like, leaves)


def save_params_orbax(path: str, params: Any) -> None:
    """Save a parameter tree as a checkpoint directory (``torch.save`` of its
    host tensors in ``params.pt``); overwrites ``path``'s checkpoint atomically."""
    os.makedirs(path, exist_ok=True)
    flat = {"/".join(p): torch.as_tensor(_host(leaf)) for p, leaf in leaves_with_paths(params)}
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(flat, f)
        os.replace(tmp, os.path.join(path, ORBAX_FILE))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_params_orbax(path: str, like: Any) -> Any:
    """Restore a :func:`save_params_orbax` checkpoint into the structure of ``like``."""
    flat = torch.load(os.path.join(path, ORBAX_FILE), map_location="cpu", weights_only=True)
    leaves = [_like(flat["/".join(p)].numpy(), leaf, "/".join(p)) for p, leaf in leaves_with_paths(like)]
    return tree_rebuild(like, leaves)
