"""Cloud normalization: centralize + common-scale into the unit ball.

Port of goicp_tpu/geom/normalize.py (numpy, host side).  Each cloud is
centred on its mean; both are divided by the larger of their max point
norms.  The reference then writes and re-reads the clouds at 6 significant
digits: io/xyz.py::quantize_like_file reproduces that.
"""

from __future__ import annotations

import numpy as np


def centralize(coords: np.ndarray):
    """Returns (centered coords, mean (3,), max point norm)."""
    coords = np.asarray(coords, dtype=np.float64)
    mean = coords.mean(axis=0)
    centered = coords - mean
    max_norm = float(np.linalg.norm(centered, axis=1).max())
    return centered, mean, max_norm


def normalize_pair(source: np.ndarray, target: np.ndarray):
    """Centralize both clouds and scale by the common max norm.

    Returns dict with src/tgt normalized coords, means, and the scale.
    """
    src_c, src_mean, src_norm = centralize(source)
    tgt_c, tgt_mean, tgt_norm = centralize(target)
    scale = max(src_norm, tgt_norm)
    return {
        "source": src_c / scale,
        "target": tgt_c / scale,
        "source_mean": src_mean,
        "target_mean": tgt_mean,
        "scale": scale,
    }
