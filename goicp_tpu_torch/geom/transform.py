"""Rigid transforms and the denormalization ("rescale") identity.

Port of goicp_tpu/geom/transform.py.  rescale (transformation.cpp:403-417):
the search runs in the normalized frame (centralized, common scale s).
Mapping the result back to world coordinates keeps R and sets
    t_world = -R @ mean_src + s * t + mean_tgt.
"""

from __future__ import annotations

import numpy as np


def apply_rigid(coords: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return np.asarray(coords) @ np.asarray(R).T + np.asarray(t).reshape(1, 3)


def rescale_transform(R: np.ndarray, t: np.ndarray, scale: float,
                      mean_src: np.ndarray, mean_tgt: np.ndarray):
    """Normalized-frame (R, t) -> world-frame (R, t_world)."""
    R = np.asarray(R, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64).reshape(3)
    t_world = -R @ np.asarray(mean_src).reshape(3) + scale * t \
        + np.asarray(mean_tgt).reshape(3)
    return R, t_world
