"""Articulated-tree helpers (counterpart of `mobileposer_tpu/kinematics/spatial.py`).

Conventions match the reference: parent[i] < i for i > 0; parent[0] is
None/-1. The tree FK/IK functions arrive with the slices that run them.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def _canon_parent(parent: Sequence) -> Tuple[int, ...]:
    """Normalize the parent list: root's parent becomes -1."""
    out = []
    for i, p in enumerate(parent):
        out.append(-1 if (i == 0 or p is None or p < 0) else int(p))
    return tuple(out)
