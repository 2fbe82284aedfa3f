"""RMSD between index-aligned point sets (transformation.cpp:453-464).

Port of goicp_tpu/geom/rmsd.py.
"""

from __future__ import annotations

import numpy as np


def rmsd(a: np.ndarray, b: np.ndarray) -> float:
    """sqrt(mean over points of squared distance); arrays index-aligned.
    The reference reads past the end of b when it is shorter; here
    mismatched shapes raise."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"RMSD shape mismatch {a.shape} vs {b.shape}")
    return float(np.sqrt(np.sum((a - b) ** 2) / len(a)))
