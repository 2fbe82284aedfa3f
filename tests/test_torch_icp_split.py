"""The ICP kernel's partition of an iteration (goicp_tpu_torch/csrc/icp.cu),
modelled in numpy float32 and held to the plain pieces on the CPU.

A row runs on a cluster of C blocks; block r takes the contiguous share
[r ceil(Nd / C), ...) of the data points and gives each point G threads
(the largest power of two <= 32 that fits 512 threads).  The nearest
neighbour: thread g scans the model points j = g (mod G) in ascending
order and keeps its first minimum, and the G partial results combine by
an xor butterfly on (d, j), the lower index winning ties.  The trimmed
modes' stable rank, once the (d2, idx) pairs have reached every block:
each block ranks its own share, the same G threads a point counting
#{j: d_j < d_i or (d_j == d_i and j < i)} over all the row's points
j = g (mod G), the integer partial counts adding up, and sends the
share's mask to every block.
The shares' (d2, idx) pairs and mask, gathered back, with every point's
rotation (each block rotates all of them), are the arrays the sums read.
Each model is held to torch.argmin, the stable argsort, JAX's
nn_correspondences and icp_run_plain's first iteration."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goicp_tpu.icp import icp as jicp
from goicp_tpu_torch.geom.rotation import rodrigues_np
from goicp_tpu_torch.icp import icp as ticp
from goicp_tpu_torch.utils.fp32 import ordered_sum, rotate, sq_dist3

torch.set_num_threads(1)

F32 = np.float32
THREADS = 512                   # csrc/icp.cu: kIcpThreads
INT_MAX = np.iinfo(np.int32).max


def shares(nd, c):
    """[(lo, nb)] of the C blocks of a row (icp_share)."""
    per = -(-nd // c)
    return [(r * per, max(0, min(nd - r * per, per))) for r in range(c)]


def threads_per_point(nb):
    """G: the largest power of two <= 32 with nb * G <= 512 (at least 1)."""
    g = 32
    while g > 1 and nb * g > THREADS:
        g //= 2
    return g


def cluster_of(nd):
    """C of goicp_icp_run's launch: ceil(Nd / 32), at most 8."""
    return min(8, max(1, -(-nd // 32)))


def butterfly(vals, combine, G):
    """Every lane's value after the xor butterfly over G lanes (off = G/2,
    ..., 1): vals (..., G) tuples of arrays, combine(a, b) -> a's new
    value; lane 0's result."""
    lanes = np.arange(G)
    off = G // 2
    while off:
        other = tuple(v[..., lanes ^ off] for v in vals)
        vals = combine(vals, other)
        off //= 2
    return tuple(v[..., 0] for v in vals)


def split_first_min(d, G):
    """(d, j) of the first minimum of each row of d (n, m) by G threads: lane
    g's first minimum over j = g (mod G), then the (d, j) butterfly."""
    n, m = d.shape
    best = np.full((n, G), np.inf, F32)
    arg = np.full((n, G), INT_MAX, np.int64)
    for g in range(min(G, m)):
        col = d[:, g::G]
        k = np.argmin(col, axis=1)                # first minimum of the lane
        best[:, g] = col[np.arange(n), k]
        arg[:, g] = g + G * k

    def combine(a, b):
        take = (b[0] < a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
        return np.where(take, b[0], a[0]), np.where(take, b[1], a[1])
    return butterfly((best, arg), combine, G)


def split_rank(d2, idx, G):
    """The stable ranks of d2[idx] among all of d2, G threads a point: lane
    g counts over j = g (mod G), the integer counts added by the
    butterfly."""
    nd = len(d2)
    j = np.arange(nd)
    counts = np.zeros((len(idx), G), np.int64)
    for g in range(G):
        dj, jj = d2[g::G], j[g::G]
        di, ii = d2[idx][:, None], np.asarray(idx)[:, None]
        counts[:, g] = ((dj[None, :] < di)
                        | ((dj[None, :] == di) & (jj[None, :] < ii))).sum(1)
    return butterfly((counts,), lambda a, b: (a[0] + b[0],), G)[0]


def stable_rank(d2):
    """The position of each entry in argsort(stable=True)."""
    order = torch.argsort(torch.from_numpy(d2), stable=True).numpy()
    rank = np.empty(len(d2), np.int64)
    rank[order] = np.arange(len(d2))
    return rank


def _clouds(nd, m, seed, dup=0):
    """data (nd, 3), model (m, 3) float32: the data the model's points (in
    turn) rotated, shifted and noisy; the first `dup` model points repeated
    at the model's end (exact ties)."""
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.7, 0.7, (m - dup, 3))
    model = np.vstack([model, model[:dup]])
    data = (model[np.arange(nd) % m] - rng.uniform(-0.05, 0.05, 3)) \
        @ rodrigues_np(rng.uniform(-0.3, 0.3, 3)) \
        + rng.normal(0, 0.003, (nd, 3))
    return data.astype(F32), model.astype(F32)


# ---------------------------------------------------------------------------
# the nearest neighbour split over G threads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("nd, m, dup", [(40, 44, 0), (165, 306, 0),
                                        (64, 37, 12), (48, 50, 25)])
def test_split_first_minimum_equals_argmin(G, nd, m, dup):
    """The (d, j) combine of G partial first minima is the serial scan's
    first minimum: torch.argmin over the plain squared distances, and
    JAX's nn_correspondences' index (G not dividing M, exact ties from
    repeated model points)."""
    data, model = _clouds(nd, m, seed=nd + m + G, dup=dup)
    pts = torch.from_numpy(data)
    d = sq_dist3(pts, torch.from_numpy(model))
    want_idx, want_d2 = ticp.nn_correspondences(pts, torch.from_numpy(model))
    best, arg = split_first_min(d.numpy(), G)
    np.testing.assert_array_equal(arg, want_idx.numpy())
    np.testing.assert_array_equal(np.maximum(best, 0).view(np.int32),
                                  want_d2.numpy().view(np.int32))
    j_idx, _ = jicp.nn_correspondences(jnp.asarray(data), jnp.asarray(model))
    np.testing.assert_array_equal(arg, np.asarray(j_idx))
    if dup:
        # the ties the test is about: some nearest point has a twin
        twins = set(range(dup)) | set(range(m - dup, m))
        assert twins & set(arg.tolist())
        assert not (set(arg.tolist()) & set(range(m - dup, m)))


def test_split_first_minimum_on_equal_distances():
    """Rows of equal distances (+0.0 and -0.0 among them) take the lowest
    index at every G, as the serial scan does."""
    d = np.array([[3.0, 1.0, 1.0, 2.0, 1.0, 1.0, 0.5, 0.5],
                  [0.0, -0.0, 0.0, -0.0, 1.0, 1.0, 1.0, 1.0],
                  [-0.0, 0.0, 5.0, 5.0, 5.0, 5.0, 5.0, 5.0],
                  [np.inf] * 8], F32)
    for G in (1, 2, 4, 8, 16):
        best, arg = split_first_min(d, G)
        np.testing.assert_array_equal(arg, torch.argmin(
            torch.from_numpy(d), dim=1).numpy())
        np.testing.assert_array_equal(best.view(np.int32), d[
            np.arange(4), arg].view(np.int32))


# ---------------------------------------------------------------------------
# the stable rank split over G threads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 4, 16, 32])
def test_split_rank_equals_the_stable_argsort(G):
    """Integer partial counts add up to the stable argsort's position:
    ties, padded rows at 1e12 (ranked last in order) and a +0.0 / -0.0
    pair (equal, the lower index first)."""
    rng = np.random.default_rng(G)
    d2 = rng.uniform(0, 0.02, 61).astype(F32)
    d2[5:9] = d2[20]                                # ties
    d2[40:48] = F32(1.0e12)                         # padded rows
    d2[11], d2[3] = F32(-0.0), F32(0.0)             # equal zeros
    d2[30] = F32(0.0)
    got = split_rank(d2, np.arange(len(d2)), G)
    np.testing.assert_array_equal(got, stable_rank(d2))
    assert got[3] < got[11] < got[30]
    np.testing.assert_array_equal(np.sort(got[40:48]), got[40:48])
    assert (got[40:48] >= len(d2) - 8).all()


# ---------------------------------------------------------------------------
# the shares, gathered back, against the plain loop's first iteration
# ---------------------------------------------------------------------------

def _dot3_warp(a, b):
    z = (a * b).astype(F32) + F32(0.0)
    return (z[..., 0] + z[..., 2]) + z[..., 1]


def kernel_iteration(data, model, R, t, c, *, mode, inlier_num,
                     data_mask=None, count=None):
    """pts, d2, idx and mask of one iteration as C blocks make them: each
    block rotates its share and finds its nearest neighbours by G threads a
    point; the shares are written into whole arrays as the blocks send
    them (the share's rotated points are every point's rotation, which
    each block also makes); then (trimmed) each block ranks its share
    among all the points, by the share's G threads a point, and its mask
    is written into the whole mask."""
    nd = len(data)
    qq = _dot3_warp(model, model)
    pts = np.zeros((nd, 3), F32)
    d2 = np.zeros(nd, F32)
    idx = np.zeros(nd, np.int64)
    for lo, nb in shares(nd, c):
        if nb == 0:
            continue
        G = threads_per_point(nb)
        q = np.stack([_dot3_warp(R[r][None, :], data[lo:lo + nb]) + t[r]
                      for r in range(3)], axis=1).astype(F32)
        pp = _dot3_warp(q, q)
        pq = _dot3_warp(q[:, None, :], model[None, :, :])
        d = (pp[:, None] - F32(2.0) * pq) + qq[None, :]
        best, arg = split_first_min(d.astype(F32), G)
        best = np.where(best < 0, F32(0.0), best)
        if data_mask is not None:
            best = np.where(data_mask[lo:lo + nb] > 0, best, F32(1.0e12))
        pts[lo:lo + nb], d2[lo:lo + nb], idx[lo:lo + nb] = q, best, arg
    mask = np.ones(nd, F32) if data_mask is None or mode != ticp.MODE_COUNT \
        else data_mask.astype(F32)
    if mode in (ticp.MODE_TRIM, ticp.MODE_DYN_TRIM):
        mask = np.zeros(nd, F32)
        for lo, nb in shares(nd, c):
            if nb == 0:
                continue
            rank = split_rank(d2, np.arange(lo, lo + nb),
                              threads_per_point(nb))
            keep = rank < inlier_num if mode == ticp.MODE_TRIM \
                else rank.astype(F32) < F32(count)
            mask[lo:lo + nb] = keep.astype(F32)
    return pts, d2, idx, mask


def _plain_first_iteration(data, model, R, t, *, inlier_num, data_mask=None,
                           count=None, dynamic_trim=False):
    """icp_run_plain's first iteration, piece by piece (one row)."""
    D, M = torch.from_numpy(data), torch.from_numpy(model)
    pts = rotate(torch.from_numpy(R)[None], D, torch.from_numpy(t)[None])
    idx, d2 = ticp.nn_correspondences(pts, M)
    n = len(data)
    if data_mask is not None:
        d2 = torch.where(torch.from_numpy(data_mask) > 0, d2, 1.0e12)
    if dynamic_trim or (count is None and inlier_num < n):
        keep = int(count) if dynamic_trim else inlier_num
        order = torch.argsort(d2, dim=-1, stable=True)
        mask = torch.zeros_like(d2).scatter(
            1, order, (torch.arange(n) < keep).to(torch.float32)[None])
    elif count is not None:
        mask = torch.from_numpy(data_mask)[None]
    else:
        mask = torch.ones_like(d2)
    return pts[0], d2[0], idx[0], mask[0]


@pytest.mark.parametrize("case, c", [
    ("165 untrimmed", 4), ("165 untrimmed", 6), ("165 untrimmed", 7),
    ("306 static trim", 4), ("306 static trim", 7), ("306 static trim", 8),
    ("165 padded count", 5), ("165 padded count", 7),
    ("306 dynamic trim", 6), ("306 dynamic trim", 7),
    ("306 dynamic trim", 8)])
def test_gathered_shares_equal_the_plain_first_iteration(case, c):
    """Nd 165 and 306 (the bench's smallest and largest clouds; 165 padded
    to 192) over C blocks that do not divide them: the gathered pts, d2,
    idx and mask equal icp_run_plain's first iteration bit for bit, and
    icp_run_plain at max_iter 1 returns that idx and err."""
    nd = int(case.split()[0])
    data, model = _clouds(nd, 306, seed=nd + c)
    rng = np.random.default_rng(c)
    R = rodrigues_np(rng.uniform(-0.2, 0.2, 3)).astype(F32)
    t = rng.uniform(-0.03, 0.03, 3).astype(F32)
    kw = dict(inlier_num=nd)
    if "padded" in case or "dynamic" in case:
        pad = 192 - nd if nd < 192 else 10
        data = np.vstack([data, np.full((pad, 3), 4.0e3, F32)])
        kw["data_mask"] = np.r_[np.ones(nd), np.zeros(pad)].astype(F32)
        kw["inlier_num"] = nd + pad
        kw["count"] = F32(nd if "count" in case else int(0.9 * nd))
        kw["dynamic_trim"] = "dynamic" in case
    if "static" in case:
        kw["inlier_num"] = int(0.9 * nd)
    assert len(data) % c and len(data) >= c
    mode = ticp.icp_mode(len(data), kw["inlier_num"], kw.get("count"),
                         kw.get("data_mask"), kw.get("dynamic_trim", False))
    got = kernel_iteration(data, model, R, t, c, mode=mode,
                           inlier_num=kw["inlier_num"],
                           data_mask=kw.get("data_mask"),
                           count=kw.get("count"))
    want = _plain_first_iteration(data, model, R, t, **kw)
    for name, g, w in zip(("pts", "d2", "idx", "mask"), got, want):
        w = w.numpy()
        if w.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=name)
    tkw = {k: (torch.as_tensor(v) if isinstance(v, (np.ndarray, np.floating))
               else v) for k, v in kw.items()}
    one = ticp.icp_run_plain(torch.from_numpy(data), torch.from_numpy(model),
                             torch.from_numpy(R)[None],
                             torch.from_numpy(t)[None], max_iter=1,
                             err_diff=1e-6, **tkw)
    np.testing.assert_array_equal(one.nn_idx[0].numpy(), got[2])
    err = ordered_sum(torch.from_numpy(got[1] * got[3]))
    assert torch.equal(one.err[0].view(torch.int32), err.view(torch.int32))


def test_launch_shapes_cover_every_point_once():
    """C = ceil(Nd / 32) <= 8 blocks; their shares cover 0..Nd-1 once, no
    share is empty, and each share's G threads a point fit the block."""
    for nd in range(1, 4300, 7):
        c = cluster_of(nd)
        cover = np.concatenate([np.arange(lo, lo + nb)
                                for lo, nb in shares(nd, c)])
        np.testing.assert_array_equal(cover, np.arange(nd))
        for _, nb in shares(nd, c):
            assert nb >= 1
            assert nb * threads_per_point(nb) <= max(THREADS, nb)
