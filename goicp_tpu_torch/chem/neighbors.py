"""Neighbour counts and per-point weights (numpy, host side).

Port of goicp_tpu/chem/neighbors.py, reference quirks included:
  * a neighbour of p is a point q != p with ||p - q|| < sqrt(radius_arg)
    (the radius argument is a squared distance);
  * the weights grow the radius argument from 0.035 by 0.001 until the
    largest count reaches 19; the counts of the last pass are kept, while
    minN is the minimum over all passes (the first pass's, as counts only
    grow); weights[i] = 1 + 2 * minN / counts_i, both clamped >= 1.
"""

from __future__ import annotations

import numpy as np


def _pairwise_dist(coords: np.ndarray) -> np.ndarray:
    d = coords[:, None, :] - coords[None, :, :]
    dist = np.sqrt((d * d).sum(-1))
    np.fill_diagonal(dist, np.inf)
    return dist


def neighbor_counts(coords: np.ndarray, radius_arg: float) -> np.ndarray:
    """Counts of j != i with ||p_i - p_j|| < sqrt(radius_arg)."""
    dist = _pairwise_dist(np.asarray(coords, dtype=np.float64))
    return (dist < np.sqrt(radius_arg)).sum(axis=1).astype(np.int32)


def adaptive_neighbor_counts(coords: np.ndarray, start: float = 0.035,
                             step: float = 0.001, target_max: int = 19,
                             max_passes: int = 10_000):
    """Grow the radius argument from `start` by `step` until the largest
    count reaches `target_max`.  Returns (counts of the final pass, minN =
    the minimum count over all passes, the final radius argument)."""
    dist = _pairwise_dist(np.asarray(coords, dtype=np.float64))
    r = start
    min_n = 100  # the reference's initial value
    for _ in range(max_passes):
        counts = (dist < np.sqrt(r)).sum(axis=1).astype(np.int32)
        min_n = min(min_n, int(counts.min(initial=100)))
        if counts.max(initial=0) >= target_max:
            break
        r += step
    return counts, min_n, r


def neighbor_weights(data_coords: np.ndarray) -> np.ndarray:
    """weights = 1 + 2 * minN / counts (the ponderation=1 path)."""
    counts, min_n, _ = adaptive_neighbor_counts(data_coords)
    min_n = max(min_n, 1)
    counts = np.maximum(counts, 1)
    return (1.0 + 2.0 * min_n / counts).astype(np.float32)
