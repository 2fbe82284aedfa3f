"""Optional chemistry/shape features present in the reference as dead code.

Port of goicp_tpu/chem/extras.py (numpy, the same functions).

The reference carries several experiment leftovers that are implemented but
never called (all call sites commented out).  They are provided here as
working, tested utilities so a user of the reference finds every capability,
wired as opt-in functions rather than search terms (matching the reference,
where none of them contributes to the error):

  * property-density per point + density differences
    (GoICP::neighborsDensity jly_goicp.cpp:1503-1570,
     computeDensityDifference :1575-1605, sumDensities :1610-1617);
  * thresholded / bucketed neighbor-mismatch variants V2 and V3
    (compareNeighborsV2 :1290-1328, compareNeighborsV3 :1330-1406);
  * covariance eigen shape features: planarity (l2-l3)/l1 and scattering
    l3/l1 (calculateCovarianceMatrix :1136-1170, computePlanarity /
    computeScattering :1191-1197 — the reference's eigen solver itself is
    commented out entirely; we use a real symmetric eigendecomposition).
"""

from __future__ import annotations

import numpy as np

from goicp_tpu_torch.chem.neighbors import _pairwise_dist


def property_density(coords: np.ndarray, props: np.ndarray,
                     start: float = 0.035, step: float = 0.001,
                     target_max: int = 19,
                     max_passes: int = 10_000) -> np.ndarray:
    """Per-point fraction of same-property neighbors, with the reference's
    adaptive radius growth (neighborsDensity, jly_goicp.cpp:1503-1533):
    grow the radius argument until the max neighbor count reaches 19; the
    densities of the FINAL pass are kept.  count==0 yields nan in the
    reference (0/0); we return 0.0 for those points."""
    coords = np.asarray(coords, dtype=np.float64)
    props = np.asarray(props)
    dist = _pairwise_dist(coords)
    np.fill_diagonal(dist, np.inf)
    same = props[:, None] == props[None, :]
    r = start
    n = len(coords)
    # NB: the reference loops forever on clouds with < target_max+1 points
    # (jly_goicp.cpp:1507 has no fallback); stop once every point sees the
    # whole cloud, and cap passes like chem/neighbors.adaptive_neighbor_counts
    # (unnormalized coordinates would otherwise need millions of passes)
    for _ in range(max_passes):
        nbr = dist < np.sqrt(r)
        counts = nbr.sum(axis=1)
        if counts.max(initial=0) >= min(target_max, n - 1):
            break
        r += step
    same_counts = (nbr & same).sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        dens = np.where(counts > 0, same_counts / np.maximum(counts, 1), 0.0)
    return dens.astype(np.float32)


def density_difference_icp(src_density: np.ndarray, tgt_density: np.ndarray,
                           nn_idx: np.ndarray) -> np.ndarray:
    """|density_src_i - density_tgt_corr(i)| over ICP correspondences
    (computeDensityDifference icp path, jly_goicp.cpp:1578-1580)."""
    return np.abs(np.asarray(src_density)
                  - np.asarray(tgt_density)[np.asarray(nn_idx)])


def density_difference_bnb(src_density: np.ndarray, tgt_density: np.ndarray,
                           cell_points: np.ndarray,
                           cell_ids: np.ndarray) -> np.ndarray:
    """Per data point: min |density diff| over the points of its nearest
    occupied cell (computeDensityDifference BnB path,
    jly_goicp.cpp:1582-1603; the reference's minD starts at 100)."""
    src = np.asarray(src_density, np.float64)
    tgt = np.asarray(tgt_density, np.float64)
    pts = np.asarray(cell_points)[np.asarray(cell_ids)]       # (N, K)
    valid = pts >= 0
    diffs = np.abs(src[:, None] - tgt[np.clip(pts, 0, None)])
    diffs = np.where(valid, diffs, np.inf)
    out = diffs.min(axis=1)
    return np.where(np.isfinite(out), out, 100.0)             # minD init


def neighbor_mismatch_v2(src_nbrs: np.ndarray,
                         tgt_nbrs: np.ndarray) -> int:
    """Sum of |n_src - n_tgt| over matched points, counting only pairs whose
    difference exceeds 3 (compareNeighborsV2, jly_goicp.cpp:1290-1328).
    Callers supply already-matched neighbor-count arrays (ICP
    correspondences or nearest-cell neighbors, as in V1)."""
    diff = np.abs(np.asarray(src_nbrs, np.int64)
                  - np.asarray(tgt_nbrs, np.int64))
    return int(diff[diff > 3].sum())


def neighbor_mismatch_v3(src_nbrs: np.ndarray,
                         tgt_nbrs: np.ndarray) -> int:
    """Bucketed mismatch (compareNeighborsV3, jly_goicp.cpp:1330-1406):
    buckets {0,1,2}, {3,4}, {5,6}; scores per the reference's exact case
    table (note: source counts >= 7 contribute nothing, and a source in
    {3,4} scores 1 against ANY target outside {3,4}, including >= 7)."""
    s = np.asarray(src_nbrs, np.int64)
    t = np.asarray(tgt_nbrs, np.int64)
    s_low, s_mid, s_high = s <= 2, (s == 3) | (s == 4), (s == 5) | (s == 6)
    t_low, t_mid, t_high = t <= 2, (t == 3) | (t == 4), (t == 5) | (t == 6)
    score = (np.where(s_low & t_mid, 1, 0)
             + np.where(s_low & t_high, 2, 0)
             + np.where(s_mid & ~t_mid, 1, 0)
             + np.where(s_high & t_low, 2, 0)
             + np.where(s_high & t_mid, 1, 0))
    return int(score.sum())


def covariance_matrix(points: np.ndarray) -> np.ndarray:
    """Sample covariance (divides by n-1) of a point set
    (calculateCovarianceMatrix, jly_goicp.cpp:1136-1170)."""
    pts = np.asarray(points, np.float64)
    mu = pts.mean(axis=0)
    d = pts - mu
    return d.T @ d / (len(pts) - 1)


def eigen_shape_features(points: np.ndarray) -> dict:
    """Descending eigenvalues of the covariance + planarity (l2-l3)/l1 and
    scattering l3/l1 (computePlanarity/computeScattering,
    jly_goicp.cpp:1191-1197; the reference's solver is commented out)."""
    w = np.linalg.eigvalsh(covariance_matrix(points))[::-1]   # l1 >= l2 >= l3
    l1, l2, l3 = (float(v) for v in w)
    return dict(eigenvalues=(l1, l2, l3),
                planarity=(l2 - l3) / l1,
                scattering=l3 / l1)
