"""Pickle checkpoints (port of the pickle pair of ``utils/checkpoint.py``).

``save_checkpoint`` writes atomically (a temporary file in the target's
directory, then ``os.replace``); the tournament's stage checkpoints use it.
Tensors pickle with their device, so a checkpoint of agents on the card loads
on a card.  The npz and Orbax parameter files are ROADMAP queue 1 item 12.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any


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
