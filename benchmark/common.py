"""What every part of the benchmark shares: its paths, seed derivation and JSON loading."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NEG_INF = -1e9


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one named use of the run's ``--seed`` (the same
    ``seed`` and ``tags`` give the same value on every machine)."""
    text = ":".join(str(x) for x in (int(seed),) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)
