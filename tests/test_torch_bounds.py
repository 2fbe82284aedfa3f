"""Bound evaluation: the kernels' plain versions (bounds/cuda_eval.py) vs the
JAX package's XLA gather path and its Pallas kernels (interpret mode), and
the port's gather path (bounds/evaluate.py) vs the JAX gather path.

The plain versions look the nearest occupied cell up in the pair's
nearest-cell table, as the kernels do; test_table_lookup_equals_min_over_cells
holds that against a scan of the cells.

Tolerances: untrimmed sums atol 1e-5 (the same integer-exact distances,
summed in another order); trimmed sums rtol 1e-5 / atol 1e-4 (the same
inlier set, summed in another order); incompatibility counts exact.
The kernels themselves run only on a CUDA card (tests marked `cuda`).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from goicp_tpu.bounds import evaluate as jev
from goicp_tpu.bounds.pallas_eval import (chem_incomp_kernel,
                                          chem_incomp_kernel_lanes,
                                          chem_tables, geom_table,
                                          geometric_bounds_kernel,
                                          geometric_bounds_kernel_lanes)
from goicp_tpu.config import GoICPConfig
from goicp_tpu.pipeline import prepare as jprep
from goicp_tpu_torch.bounds import cuda_eval
from goicp_tpu_torch.bounds import evaluate as tev
from goicp_tpu_torch.dist.mesh import stack_pairs
from goicp_tpu_torch.grid.edt import nearest_occupied
from goicp_tpu_torch.grid.lookup import oob_extension, voxel_indices
from goicp_tpu_torch.pipeline.prepare import (make_count_dynamic,
                                              pair_from_jax)

UNTRIMMED = dict(rtol=0, atol=1e-5)
TRIMMED = dict(rtol=1e-5, atol=1e-4)


def _pair(n=37, m=41, pad_to=64, seed=3, **cfg_kw):
    rng = np.random.default_rng(seed)
    cfg = GoICPConfig(**{"regularization": 0.0005, "ponderation": 1,
                         "distTransSize": 12, **cfg_kw})
    src = rng.uniform(-0.7, 0.7, size=(n, 3))
    tgt = rng.uniform(-0.7, 0.7, size=(m, 3))
    sp = rng.integers(0, 9, size=n).astype(np.int32)
    tp = rng.integers(0, 9, size=m).astype(np.int32)
    jp = jprep.prepare_pair(src, tgt, sp, tp, cfg, pad_data_to=pad_to)
    return jp, pair_from_jax(jp, "cpu"), cfg


def _lanes(nd, seed, L=4, B=8, shift=0.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.9, 0.9, size=(L, nd, 3)).astype(np.float32)
    centers = (rng.uniform(-0.6, 0.6, size=(L, B, 3)) + shift
               ).astype(np.float32)
    widths = rng.uniform(0.05, 0.5, size=(L, B)).astype(np.float32)
    rw = rng.uniform(0.1, 1.0, size=(L,)).astype(np.float32)
    return pts, centers, widths, rw


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def _plain_and_refs(jp, tp, cfg, pts, centers, widths, rw, unc,
                    fused=False, trim_k=0, dynamic=False):
    """(plain, xla, pallas) bound tuples for the same inputs."""
    (jpts, jcen, jwid, jrw), (tpts, tcen, twid, trw) = \
        _both(pts, centers, widths, rw)
    junc = jev.rot_uncertainty(jrw, jp.norm_data) if unc else None
    tunc = tev.rot_uncertainty(trw, tp.norm_data) if unc else None
    if fused and not unc:
        junc = jnp.zeros((pts.shape[0], pts.shape[1]), jnp.float32)
        tunc = torch.zeros((pts.shape[0], pts.shape[1]))
    size = jp.grid.geom.size
    kcount = float(jp.inlier_num) if dynamic else None
    plain = cuda_eval.geometric_bounds_plain(
        tpts, tcen, twid, tunc, tp.weights, tp.grid.cell_coords,
        tp.grid.nearest_cell, tp.grid.consts,
        torch.tensor(kcount) if dynamic else None,
        size=size, norm=cfg.norm, fused=fused,
        trim_k=0 if dynamic else trim_k)
    pal = geometric_bounds_kernel(
        jpts, jcen, jwid, junc, jp.weights, jp.grid.cell_coords,
        jp.grid.consts, jnp.float32(kcount) if dynamic else None,
        size=size, norm=cfg.norm, fused=fused,
        trim_k=0 if dynamic else trim_k, interpret=True)
    jq = jprep.make_count_dynamic(jp) if dynamic else jp
    f = jev.geometric_bounds_fused if fused else jev.geometric_bounds
    xla = f(jq, cfg, jpts, jcen, jwid, junc)
    return plain, xla, pal


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("unc", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_geometric_plain_untrimmed(norm, unc, fused):
    jp, tp, cfg = _pair(norm=norm)
    args = _lanes(jp.n_data_padded, 11)
    plain, xla, pal = _plain_and_refs(jp, tp, cfg, *args, unc, fused=fused)
    assert len(plain) == (3 if fused else 2)
    _close(plain, xla, UNTRIMMED)
    _close(plain, pal, UNTRIMMED)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dynamic", [False, True])
def test_geometric_plain_trimmed(fused, dynamic):
    jp, tp, cfg = _pair(trimFraction=0.2)
    assert jp.inlier_num < jp.n_data
    args = _lanes(jp.n_data_padded, 17)
    plain, xla, pal = _plain_and_refs(jp, tp, cfg, *args, True, fused=fused,
                                      trim_k=jp.inlier_num, dynamic=dynamic)
    _close(plain, xla, TRIMMED)
    _close(plain, pal, TRIMMED)


def test_geometric_plain_out_of_bounds():
    """Centers far outside the grid exercise the out-of-bounds extension."""
    jp, tp, cfg = _pair()
    args = _lanes(jp.n_data_padded, 5, shift=2.5)
    plain, xla, pal = _plain_and_refs(jp, tp, cfg, *args, False)
    _close(plain, xla, dict(rtol=1e-6, atol=1e-5))
    _close(plain, pal, dict(rtol=1e-6, atol=1e-5))


def test_geometric_plain_cells_padded_to_1200():
    """The cell table padded past 512 entries with cells outside the grid
    (never winners): the kernel contract of test_pallas_eval.py:78."""
    jp, tp, cfg = _pair()
    pts, centers, widths, _ = _lanes(jp.n_data_padded, 13)
    cells = np.asarray(jp.grid.cell_coords)
    big = np.concatenate([cells, np.full((1200 - len(cells), 3), -9,
                                         cells.dtype)])
    (jpts, jcen, jwid), (tpts, tcen, twid) = _both(pts, centers, widths)
    xla = jev.geometric_bounds(jp, cfg, jpts, jcen, jwid, None)
    size = jp.grid.geom.size
    pal = geometric_bounds_kernel(jpts, jcen, jwid, None, jp.weights,
                                  jnp.asarray(big), jp.grid.consts,
                                  size=size, norm=2, interpret=True)
    plain = cuda_eval.geometric_bounds_plain(
        tpts, tcen, twid, None, tp.weights, torch.as_tensor(big),
        tp.grid.nearest_cell, tp.grid.consts, size=size, norm=2)
    _close(plain, xla, UNTRIMMED)
    _close(plain, pal, UNTRIMMED)


def test_geometric_plain_more_than_512_cells():
    """A 1400-point model on a 28^3 grid: > 512 real occupied cells
    (test_pallas_eval.py:201)."""
    rng = np.random.default_rng(19)
    cfg = GoICPConfig(regularization=0.0, ponderation=0, distTransSize=28)
    src = rng.uniform(-0.7, 0.7, size=(40, 3))
    tgt = rng.uniform(-0.9, 0.9, size=(1400, 3))
    jp = jprep.prepare_pair(src, tgt, np.zeros(40, np.int32),
                            np.zeros(1400, np.int32), cfg, pad_data_to=64)
    tp = pair_from_jax(jp, "cpu")
    assert jp.grid.cell_coords.shape[0] > 512
    args = _lanes(jp.n_data_padded, 19)
    plain, xla, pal = _plain_and_refs(jp, tp, cfg, *args, False)
    _close(plain, xla, UNTRIMMED)
    _close(plain, pal, UNTRIMMED)


def _big_grid_pair():
    """A 1400-point model on a 28^3 grid: > 512 real occupied cells."""
    rng = np.random.default_rng(19)
    cfg = GoICPConfig(regularization=0.0005, ponderation=1, distTransSize=28,
                      trimFraction=0.2)
    src = rng.uniform(-0.7, 0.7, size=(40, 3))
    tgt = rng.uniform(-0.9, 0.9, size=(1400, 3))
    jp = jprep.prepare_pair(src, tgt, rng.integers(0, 9, 40).astype(np.int32),
                            rng.integers(0, 9, 1400).astype(np.int32), cfg,
                            pad_data_to=64)
    return pair_from_jax(jp, "cpu")


@pytest.mark.parametrize("case", ["in_grid", "out_of_bounds",
                                  "cells_padded_to_1200", "over_512_cells"])
@pytest.mark.parametrize("mode", ["untrimmed", "static", "dynamic", "chem"])
def test_table_lookup_equals_min_over_cells(mode, case):
    """The plain versions read Grid.nearest_cell; the same bounds from a
    scan of all cells (nearest_occupied, the first-minimum argmin that built
    the table) must agree: per-point distances bit for bit (the same
    integer squared distance goes through the same sqrt and division), the
    sums to atol 1e-5 (they are the same reductions of equal values, so
    they come out equal; the tolerance is that of the other sum tests), the
    incompatibility counts exactly."""
    tp = _big_grid_pair() if case == "over_512_cells" \
        else _pair(trimFraction=0.2)[1]
    g = tp.grid
    size = g.geom.size
    cells = g.cell_coords
    if case == "cells_padded_to_1200":
        cells = torch.cat([cells, torch.full((1200 - len(cells), 3), -9,
                                             dtype=cells.dtype)])
    if case == "over_512_cells":
        assert g.n_cells > 512
    pts, centers, widths, rw = _lanes(
        tp.n_data_padded, 23, shift=2.5 if case == "out_of_bounds" else 0.0)
    tpts, tcen, twid, trw = (torch.as_tensor(a)
                             for a in (pts, centers, widths, rw))
    pos = tpts[:, None, :, :] + tcen[:, :, None, :]
    raw, clamped = voxel_indices(pos, g.consts)
    d2, cell = nearest_occupied(clamped.reshape(-1, 3), cells, size)
    if mode == "chem":
        compat = tp.cell_compat
        if case == "cells_padded_to_1200":
            compat = torch.cat([compat, torch.zeros(
                (1200 - len(compat), compat.shape[1]))])
        h = compat[cell].reshape(pos.shape[:-1] + (compat.shape[1],))
        inc = (tp.data_mask > 0).to(torch.float32)[None, None, :] \
            - torch.sum(tp.prop_onehot[None, None] * h, dim=-1)
        want = torch.sum(inc, dim=-1)
        got = cuda_eval.chem_incomp_plain(
            tpts, tcen, compat, tp.prop_onehot, tp.data_mask,
            g.nearest_cell, g.consts, size=size)
        assert torch.equal(got, want)
        return
    # numpy's float32 sqrt is correctly rounded, as the kernels'
    # __fsqrt_rn and XLA's are
    dist = torch.as_tensor(np.sqrt(d2.numpy().astype(np.float32))).reshape(
        raw.shape[:-1]) / g.consts[3]
    oob, extra = oob_extension(raw, g.consts)
    dist = torch.where(oob, dist + extra, dist)
    if case == "out_of_bounds":
        assert bool(oob.any())
    assert torch.equal(
        cuda_eval.point_distances(tpts, tcen, cells, g.nearest_cell,
                                  g.consts), dist)
    unc = tev.rot_uncertainty(trw, tp.norm_data)
    k = dict(untrimmed=None, static=tp.inlier_num,
             dynamic=torch.tensor(float(tp.inlier_num)))[mode]
    want = cuda_eval.reduce_bounds(
        tp.weights[None, None, :] * dist, twid, unc, 2, True,
        mask=(tp.weights > 0)[None, None, :], k=k, static=mode == "static")
    got = cuda_eval.geometric_bounds_plain(
        tpts, tcen, twid, unc, tp.weights, cells, g.nearest_cell, g.consts,
        k if mode == "dynamic" else None, size=size, norm=2, fused=True,
        trim_k=tp.inlier_num if mode == "static" else 0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("q", [8, 27, 152])
def test_chem_plain_exact(q):
    jp, tp, cfg = _pair()
    rng = np.random.default_rng(7)
    pts = rng.uniform(-0.9, 0.9, size=(3, jp.n_data_padded, 3)
                      ).astype(np.float32)
    corners = rng.uniform(-0.8, 0.8, size=(3, q, 3)).astype(np.float32)
    (jpts, jcor), (tpts, tcor) = _both(pts, corners)
    want = np.asarray(jev.chem_corner_values(jp, cfg, jpts, jcor)["incomp"])
    pal = np.asarray(chem_incomp_kernel(
        jpts, jcor, jp.cell_compat, jp.prop_onehot, jp.data_mask,
        jp.grid.cell_coords, jp.grid.consts, size=jp.grid.geom.size,
        interpret=True))
    got = cuda_eval.chem_incomp_plain(
        tpts, tcor, tp.cell_compat, tp.prop_onehot, tp.data_mask,
        tp.grid.nearest_cell, tp.grid.consts,
        size=tp.grid.geom.size).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pal)


def test_wrappers_take_plain_versions_on_cpu():
    jp, tp, cfg = _pair()
    pts, centers, widths, _ = _lanes(jp.n_data_padded, 3)
    _, (tpts, tcen, twid) = _both(pts, centers, widths)
    before = cuda_eval.launch_counts()
    args = (tpts, tcen, twid, None, tp.weights, tp.grid.cell_coords,
            tp.grid.nearest_cell, tp.grid.consts)
    kw = dict(size=tp.grid.geom.size, norm=2)
    for a, b in zip(cuda_eval.geometric_bounds_kernel(*args, **kw),
                    cuda_eval.geometric_bounds_plain(*args, **kw)):
        assert torch.equal(a, b)
    assert cuda_eval.launch_counts() == before


@pytest.mark.parametrize("trim", ["off", "static", "dynamic"])
@pytest.mark.parametrize("fused", [False, True])
def test_gather_path_matches_jax(trim, fused):
    jp, _, cfg = _pair(trimFraction=0.0 if trim == "off" else 0.2)
    if trim == "dynamic":
        jp = jprep.make_count_dynamic(jp)
    tp = pair_from_jax(jp, "cpu")
    pts, centers, widths, rw = _lanes(jp.n_data_padded, 29)
    (jpts, jcen, jwid, jrw), (tpts, tcen, twid, trw) = \
        _both(pts, centers, widths, rw)
    junc = jev.rot_uncertainty(jrw, jp.norm_data)
    tunc = tev.rot_uncertainty(trw, tp.norm_data)
    np.testing.assert_allclose(tunc.numpy(), np.asarray(junc), rtol=1e-6,
                               atol=1e-7)
    if fused:
        want = jev.geometric_bounds_fused(jp, cfg, jpts, jcen, jwid, junc)
        got = tev.geometric_bounds_fused(tp, cfg, tpts, tcen, twid, tunc)
    else:
        want = jev.geometric_bounds(jp, cfg, jpts, jcen, jwid, junc)
        got = tev.geometric_bounds(tp, cfg, tpts, tcen, twid, tunc)
    _close(got, want, UNTRIMMED if trim == "off" else TRIMMED)


@pytest.mark.parametrize("cfg_kw", [
    dict(),                                           # fused per-voxel table
    dict(distTransSize=40),                           # (point, cell) table
    dict(regularizationNeighbors=0.001),              # + neighbour term
])
def test_chem_gather_path_matches_jax(cfg_kw):
    jp, _, cfg = _pair(**cfg_kw)
    if cfg_kw.get("distTransSize") == 40:
        # beyond the fused-table budget the (point, cell) tables are used
        jp = jprep.prepare_pair(
            np.asarray(jp.data)[:37], np.asarray(jp.model),
            np.asarray(jp.data_props)[:37], np.asarray(jp.model_props), cfg)
        object.__setattr__(jp, "fused_chem", False)
    tp = pair_from_jax(jp, "cpu")
    rng = np.random.default_rng(31)
    pts = rng.uniform(-0.9, 0.9, size=(2, jp.n_data_padded, 3)
                      ).astype(np.float32)
    corners = rng.uniform(-0.8, 0.8, size=(2, 19, 3)).astype(np.float32)
    (jpts, jcor), (tpts, tcor) = _both(pts, corners)
    want = jev.chem_corner_values(jp, cfg, jpts, jcor)
    got = tev.chem_corner_values(tp, cfg, tpts, tcor)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    lat = {k: np.asarray(v).reshape(2, 1, 19)[..., [i % 19 for i in
                                                    range(27)]]
           for k, v in want.items()}
    jb = jev.chem_bounds_from_lattice(cfg, {k: jnp.asarray(v)
                                            for k, v in lat.items()},
                                      with_child_vals=True)
    tb = tev.chem_bounds_from_lattice(cfg, {k: torch.as_tensor(v)
                                            for k, v in lat.items()},
                                      with_child_vals=True)
    np.testing.assert_array_equal(tb[0].numpy(), np.asarray(jb[0]))
    np.testing.assert_array_equal(tb[1].numpy(), np.asarray(jb[1]))
    for k in jb[3]:
        np.testing.assert_array_equal(tb[3][k].numpy(), np.asarray(jb[3][k]))


# ---------------------------------------------------------------------------
# K3 / K4: lanes of different pairs in one call
# ---------------------------------------------------------------------------

_LANE_PAIR = [0, 1, 0, 1]


def _lane_case(device="cpu"):
    """Two pairs of one shape bucket with their lanes interleaved: the
    inputs of tests/test_pallas_eval.py's lane-table test.  Returns the
    JAX pairs, the port's pairs stacked, and the lane arrays (numpy)."""
    cfg = GoICPConfig(regularization=0.0005, ponderation=1,
                      distTransSize=12, trimFraction=0.1)
    jpairs = []
    for seed in (1, 2):
        r = np.random.default_rng(seed)
        src = r.uniform(-0.7, 0.7, size=(37, 3))
        tgt = r.uniform(-0.7, 0.7, size=(41 + seed, 3))
        jpairs.append(jprep.prepare_pair(
            src, tgt, r.integers(0, 9, 37).astype(np.int32),
            r.integers(0, 9, len(tgt)).astype(np.int32), cfg,
            pad_data_to=64, pad_cells=64, pad_points=8, pad_model_to=64))
    tpairs = [make_count_dynamic(pair_from_jax(p, device)) for p in jpairs]
    rng = np.random.default_rng(3)
    L, B, Q = 4, 16, 54
    nd = jpairs[0].n_data_padded
    arrays = dict(
        pts=rng.uniform(-0.9, 0.9, size=(L, nd, 3)),
        centers=rng.uniform(-0.5, 0.5, size=(L, B, 3)),
        widths=rng.uniform(0.05, 0.5, size=(L, B)),
        corners=rng.uniform(-0.6, 0.6, size=(L, Q, 3)),
        unc=rng.uniform(0, 0.3, size=(L, nd)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return jpairs, tpairs, stack_pairs(tpairs), arrays


def _jax_lane_tables(jpairs):
    size = jpairs[0].grid.geom.size

    def gl(per_pair):
        return jnp.stack([per_pair[i] for i in _LANE_PAIR])

    ct = [chem_tables(p.grid.cell_coords, p.cell_compat, p.prop_onehot,
                      p.data_mask, size) for p in jpairs]
    cons = gl([jnp.concatenate([p.grid.consts,
                                jnp.asarray([p.inlier_f(), 0.0, 0.0])])
               for p in jpairs])
    return dict(weights=gl([p.weights for p in jpairs]),
                g6=gl([geom_table(p.grid.cell_coords, size)
                       for p in jpairs]),
                a16=gl([a for a, _ in ct]), pp=gl([p for _, p in ct]),
                cons=cons, size=size)


def _k3_args(stacked, a, trim, device="cpu"):
    t = {k: torch.as_tensor(v, device=device) for k, v in a.items()}
    return (t["pts"], t["centers"], t["widths"], t["unc"], stacked.weights,
            stacked.grid.cell_coords, stacked.grid.nearest_cell,
            stacked.grid.consts, stacked.counts[:, 1].contiguous() if trim else None,
            torch.as_tensor(_LANE_PAIR, dtype=torch.int32, device=device))


def _k4_args(stacked, a, device="cpu"):
    t = {k: torch.as_tensor(v, device=device) for k, v in a.items()}
    return (t["pts"], t["corners"], stacked.cell_compat,
            stacked.prop_onehot, stacked.data_mask,
            stacked.grid.nearest_cell, stacked.grid.consts,
            torch.as_tensor(_LANE_PAIR, dtype=torch.int32, device=device))


@pytest.mark.parametrize("trim", [False, True])
def test_geometric_lanes_plain(trim):
    """K3's plain version vs the JAX per-lane-table kernel (interpret
    mode), and lane for lane EQUAL to K1's plain version on that lane's
    pair."""
    jpairs, tpairs, stacked, a = _lane_case()
    jt = _jax_lane_tables(jpairs)
    want = geometric_bounds_kernel_lanes(
        jnp.asarray(a["pts"]), jnp.asarray(a["centers"]),
        jnp.asarray(a["widths"]), jnp.asarray(a["unc"]), jt["weights"],
        jt["g6"], jt["cons"], size=jt["size"], norm=2, trim=trim,
        interpret=True)
    args = _k3_args(stacked, a, trim)
    got = cuda_eval.geometric_bounds_lanes_plain(*args, size=jt["size"],
                                                 norm=2)
    _close(got, want, TRIMMED if trim else UNTRIMMED)
    for lane, w in enumerate(_LANE_PAIR):
        p = tpairs[w]
        one = cuda_eval.geometric_bounds_plain(
            *(x[lane:lane + 1] for x in args[:4]), p.weights,
            p.grid.cell_coords, p.grid.nearest_cell, p.grid.consts,
            p.inlier_f() if trim else None, size=jt["size"], norm=2,
            fused=True)
        for g, o in zip(got, one):
            assert torch.equal(g[lane], o[0])


def test_chem_lanes_plain_exact():
    """K4's plain version vs the JAX per-lane-table kernel (interpret
    mode) and vs K2's plain version lane for lane: counts, exact."""
    jpairs, tpairs, stacked, a = _lane_case()
    jt = _jax_lane_tables(jpairs)
    want = np.asarray(chem_incomp_kernel_lanes(
        jnp.asarray(a["pts"]), jnp.asarray(a["corners"]), jt["a16"],
        jt["pp"], jt["cons"], size=jt["size"], interpret=True))
    args = _k4_args(stacked, a)
    got = cuda_eval.chem_incomp_lanes_plain(*args, size=jt["size"])
    np.testing.assert_array_equal(got.numpy(), want)
    for lane, w in enumerate(_LANE_PAIR):
        p = tpairs[w]
        one = cuda_eval.chem_incomp_plain(
            args[0][lane:lane + 1], args[1][lane:lane + 1], p.cell_compat,
            p.prop_onehot, p.data_mask, p.grid.nearest_cell, p.grid.consts,
            size=jt["size"])
        assert torch.equal(got[lane], one[0])


def test_lane_wrappers_take_plain_versions_on_cpu():
    _, _, stacked, a = _lane_case()
    size = stacked.grid.geom.size
    before = cuda_eval.launch_counts()
    assert set(before) == {"geometric_bounds_kernel", "chem_incomp_kernel",
                           "geometric_bounds_kernel_lanes",
                           "chem_incomp_kernel_lanes", "ordered_sum",
                           "rotate", "norm3", "sincos32",
                           "sq_dist3", "det3", "cross3", "dot_fma",
                           "rodrigues_kernel", "rot_uncertainty_kernel",
                           "icp_run", "kabsch3", "inner_step", "inner_run",
                           "harvest", "advance", "score_kernel",
                           "icp_seeds", "score_pick", "score_initial",
                           "icp_refine", "icp_init"}
    k3 = _k3_args(stacked, a, True)
    for g, w in zip(
            cuda_eval.geometric_bounds_kernel_lanes(*k3, size=size, norm=2),
            cuda_eval.geometric_bounds_lanes_plain(*k3, size=size, norm=2)):
        assert torch.equal(g, w)
    k4 = _k4_args(stacked, a)
    assert torch.equal(
        cuda_eval.chem_incomp_kernel_lanes(*k4, size=size),
        cuda_eval.chem_incomp_lanes_plain(*k4, size=size))
    assert cuda_eval.launch_counts() == before


# ---------------------------------------------------------------------------
# on the card: each kernel vs its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "unc", "fused", "static",
                                  "dynamic", "fused_dynamic", "oob"])
def test_geometric_kernel_matches_plain_on_card(cuda_device, mode):
    trimmed = mode in ("static", "dynamic", "fused_dynamic")
    _, tp, cfg = _pair(trimFraction=0.2 if trimmed else 0.0)
    tp = tp.to(cuda_device)
    pts, centers, widths, rw = _lanes(
        tp.n_data_padded, 41, L=8, B=64, shift=2.5 if mode == "oob" else 0)
    t = [torch.as_tensor(a, device=cuda_device)
         for a in (pts, centers, widths, rw)]
    unc = None if mode in ("plain", "oob") else \
        tev.rot_uncertainty(t[3], tp.norm_data).contiguous()
    kw = dict(size=tp.grid.geom.size, norm=2,
              fused=mode in ("fused", "fused_dynamic"),
              trim_k=tp.inlier_num if mode == "static" else 0)
    k = tp.inlier_f() if mode in ("dynamic", "fused_dynamic") else None
    args = (t[0], t[1], t[2], unc, tp.weights, tp.grid.cell_coords,
            tp.grid.nearest_cell, tp.grid.consts, k)
    n0 = cuda_eval.geometric_bounds_kernel.launches
    got = cuda_eval.geometric_bounds_kernel(*args, **kw)
    want = cuda_eval.geometric_bounds_plain(*args, **kw)
    assert cuda_eval.geometric_bounds_kernel.launches == n0 + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **(TRIMMED if trimmed
                                            else UNTRIMMED))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [8, 152])
def test_chem_kernel_matches_plain_on_card(cuda_device, q):
    _, tp, _ = _pair()
    tp = tp.to(cuda_device)
    rng = np.random.default_rng(43)
    pts = torch.as_tensor(rng.uniform(-0.9, 0.9, (8, tp.n_data_padded, 3)),
                          dtype=torch.float32, device=cuda_device)
    cor = torch.as_tensor(rng.uniform(-0.8, 0.8, (8, q, 3)),
                          dtype=torch.float32, device=cuda_device)
    args = (pts, cor, tp.cell_compat, tp.prop_onehot, tp.data_mask,
            tp.grid.nearest_cell, tp.grid.consts)
    got = cuda_eval.chem_incomp_kernel(*args, size=tp.grid.geom.size)
    want = cuda_eval.chem_incomp_plain(*args, size=tp.grid.geom.size)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("trim", [False, True])
def test_lane_kernels_match_plain_and_per_pair_kernels_on_card(cuda_device,
                                                               trim):
    """K3 and K4 on the card vs their plain versions, and lane for lane
    EQUAL to K1 / K2 run with that lane's pair."""
    _, tpairs, stacked, a = _lane_case(cuda_device)
    size = stacked.grid.geom.size
    k3 = _k3_args(stacked, a, trim, cuda_device)
    k4 = _k4_args(stacked, a, cuda_device)
    before = cuda_eval.launch_counts()
    got3 = cuda_eval.geometric_bounds_kernel_lanes(*k3, size=size, norm=2)
    got4 = cuda_eval.chem_incomp_kernel_lanes(*k4, size=size)
    after = cuda_eval.launch_counts()
    for name in ("geometric_bounds_kernel_lanes", "chem_incomp_kernel_lanes"):
        assert after[name] == before[name] + 1
    for g, w in zip(got3, cuda_eval.geometric_bounds_lanes_plain(
            *k3, size=size, norm=2)):
        torch.testing.assert_close(g, w, **(TRIMMED if trim else UNTRIMMED))
    assert torch.equal(got4, cuda_eval.chem_incomp_lanes_plain(*k4,
                                                               size=size))
    for lane, w in enumerate(_LANE_PAIR):
        p = tpairs[w]
        one3 = cuda_eval.geometric_bounds_kernel(
            *(x[lane:lane + 1].contiguous() for x in k3[:4]), p.weights,
            p.grid.cell_coords, p.grid.nearest_cell, p.grid.consts,
            p.inlier_f() if trim else None, size=size, norm=2, fused=True)
        for g, o in zip(got3, one3):
            assert torch.equal(g[lane], o[0])
        one4 = cuda_eval.chem_incomp_kernel(
            k4[0][lane:lane + 1].contiguous(),
            k4[1][lane:lane + 1].contiguous(), p.cell_compat, p.prop_onehot,
            p.data_mask, p.grid.nearest_cell, p.grid.consts, size=size)
        assert torch.equal(got4[lane], one4[0])


@pytest.mark.cuda
def test_kernels_match_plain_with_table_in_device_memory_on_card(cuda_device):
    """A 64^3 grid: the 1 MB nearest-cell table does not fit a block's
    shared memory, so the kernels read it (and the cells) from device
    memory.  Same tolerances as above: K1 untrimmed and trimmed sums, K2
    exact."""
    _, tp, _ = _pair(distTransSize=64, trimFraction=0.2)
    tp = tp.to(cuda_device)
    g = tp.grid
    assert g.nearest_cell.numel() * 4 > 227 * 1024
    pts, centers, widths, rw = _lanes(tp.n_data_padded, 47, L=8, B=64)
    t = [torch.as_tensor(a, device=cuda_device)
         for a in (pts, centers, widths, rw)]
    unc = tev.rot_uncertainty(t[3], tp.norm_data).contiguous()
    for k, tol in ((None, UNTRIMMED), (tp.inlier_f(), TRIMMED)):
        args = (t[0], t[1], t[2], unc, tp.weights, g.cell_coords,
                g.nearest_cell, g.consts, k)
        kw = dict(size=g.geom.size, norm=2, fused=True)
        for a, b in zip(cuda_eval.geometric_bounds_kernel(*args, **kw),
                        cuda_eval.geometric_bounds_plain(*args, **kw)):
            torch.testing.assert_close(a, b, **tol)
    cor = torch.as_tensor(
        np.random.default_rng(48).uniform(-0.8, 0.8, (8, 152, 3)),
        dtype=torch.float32, device=cuda_device)
    cargs = (t[0], cor, tp.cell_compat, tp.prop_onehot, tp.data_mask,
             g.nearest_cell, g.consts)
    assert torch.equal(
        cuda_eval.chem_incomp_kernel(*cargs, size=g.geom.size),
        cuda_eval.chem_incomp_plain(*cargs, size=g.geom.size))
