"""Small utilities mirroring the reference's utils/various.py (port of ``utils/various.py``)."""

from __future__ import annotations

import numpy as np


def iter_flatten(iterable, max_depth=None):
    """Recursive flatten with optional depth limit (reference various.py:64-72)."""
    for item in iter(iterable):
        if isinstance(item, (list, tuple, np.ndarray)) and (max_depth is None or max_depth > 0):
            yield from iter_flatten(item, None if max_depth is None else max_depth - 1)
        else:
            yield item
