"""Index arithmetic for collocation meshes.

Subintervals either share their border points (LGL states/controls, LGR
states) or keep separate points per interval (LGR controls / middle stage).
Semantics match the reference implementation
(upstream pockit ``pockit/base/discretizationbase.py:10-38``).
"""

from __future__ import annotations

import numpy as np


def lr_c(num_point: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Left/right (half-open) index ranges per interval when border points are
    shared between adjacent intervals.

    Interval ``i`` occupies ``[l[i], r[i])``; ``r[i] - 1 == l[i+1]``.
    """
    num_point = np.asarray(num_point, dtype=np.int64)
    l = np.concatenate(([0], np.cumsum(num_point[:-1] - 1)))
    return l.astype(np.int64), (l + num_point).astype(np.int64)


def lr_nc(num_point: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Left/right (half-open) index ranges per interval when each interval
    keeps its own points (no sharing)."""
    num_point = np.asarray(num_point, dtype=np.int64)
    l = np.concatenate(([0], np.cumsum(num_point[:-1])))
    return l.astype(np.int64), np.cumsum(num_point).astype(np.int64)
