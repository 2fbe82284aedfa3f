"""The rescoring of whole transforms (goicp_tpu_torch/bounds/error.py) and
its one-launch kernel (csrc/score.cu, `score_kernel`), held on the CPU:

  * the plain bodies (score_transform_plain with icp_chem_terms' count,
    bnb_incompatibility_count_plain, initial_error_plain) equal the JAX
    package's score_transform, icp_chem_terms, bnb_incompatibility_count
    and initial_error on XLA:CPU to 1e-5 absolute, counts exactly: L2 and
    L1 untrimmed, a static and a dynamic trim, the c-FPFH and the
    neighbour terms, a padded pair;
  * a numpy float32 model of the kernel's operations in its order (the
    rotation, the voxel and its out-of-grid extension, the rank placement,
    the warp-order sums, the integer counts, the terms) equals the plain
    bodies bit for bit in all three routes: ties in d, a dynamic K of 0
    and of Nd, points outside the grid (whose squared excesses no longer
    add exactly in float32), the c-FPFH term at 41 and 8 bins, 1 and 4
    rows;
  * grid/lookup.py's out-of-grid extension adds its three squares in the
    sequential order, bit for bit the JAX package's dt_distance there;
  * CPU tensors take the plain bodies and launch nothing.

The `cuda` test holds the kernel to the plain bodies on the card (it
skips without one); chip_smoke.py phase 2 does the same at the main
path's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from goicp_tpu_torch.bench import options
from goicp_tpu_torch.bounds import error as terr
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.geom.rotation import rodrigues_np
from goicp_tpu_torch.grid import lookup as tlookup
from goicp_tpu_torch.pipeline import prepare as tprep

torch.set_num_threads(1)

F32 = np.float32
BASE = dict(regularization=0.0005, ponderation=1, distTransSize=12)
# configuration, data points, padded length, dynamic counts
CASES = {
    "l2": (dict(), 48, None, False),
    "l1": (dict(norm=1), 48, None, False),
    "static trim": (dict(trimFraction=0.15), 48, 64, False),
    "dynamic trim": (dict(trimFraction=0.15), 48, 64, True),
    "cfpfh": (dict(cfpfh=1, regularizationFPFH=0.001), 44, None, False),
    "neighbours": (dict(regularizationNeighbors=0.001), 48, None, False),
    "padded": (dict(), 40, 64, True),
}


def bits(x):
    return np.asarray(x, F32).view(np.int32)


def clouds(n, m=56, seed=7, fpfh=False):
    """(data, model, data props, model props[, descriptors]): the data a
    rotated, shifted, noisy copy of the model's first n points."""
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.7, 0.7, (m, 3))
    R = rodrigues_np(rng.uniform(-0.3, 0.3, 3))
    t = rng.uniform(-0.05, 0.05, 3)
    data = (model[:n] - t) @ R + rng.normal(0, 0.01, (n, 3))
    mp = rng.integers(0, 9, m).astype(np.int32)
    dp = mp[:n].copy()
    dp[::5] = (dp[::5] + 1) % 9            # some incompatible points
    out = (data.astype(F32), model.astype(F32), dp, mp)
    return out + options.seeded_descriptors(dp, mp, seed) if fpfh else out


def transforms(K, nd, m, seed, shift=0.05):
    rng = np.random.default_rng(seed)
    R = np.stack([rodrigues_np(rng.uniform(-0.3, 0.3, 3))
                  for _ in range(K)]).astype(F32)
    t = rng.uniform(-shift, shift, (K, 3)).astype(F32)
    nn = rng.integers(0, m, (K, nd)).astype(np.int64)
    return R, t, nn


def torch_pair(case, dup=False):
    over, n, pad, dynamic = CASES[case]
    cfg = GoICPConfig(**dict(BASE, **over))
    raw = clouds(n, fpfh="cfpfh" in case)
    data = raw[0]
    if dup:                                # ties in d: repeated points
        data = data.copy()
        data[10:20] = data[0:10]
    pair = tprep.prepare_pair(data, *raw[1:4], cfg,
                              *(raw[4:] if len(raw) > 4 else ()),
                              pad_data_to=pad, device="cpu")
    if dynamic:
        pair = tprep.make_count_dynamic(pair)
    return cfg, pair


# ---------------------------------------------------------------------------
# the plain bodies against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_plain_bodies_match_jax(case):
    import jax.numpy as jnp
    from goicp_tpu.bounds import error as jerr
    from goicp_tpu.config import GoICPConfig as JConfig
    from goicp_tpu.pipeline import prepare as jprep
    over, n, pad, dynamic = CASES[case]
    cfg = GoICPConfig(**dict(BASE, **over))
    jcfg = JConfig(**dict(BASE, **over))
    raw = clouds(n, fpfh="cfpfh" in case)
    jp = jprep.prepare_pair(*raw[:4], jcfg, *raw[4:], pad_data_to=pad)
    if dynamic:
        jp = jprep.make_count_dynamic(jp)
    tp = tprep.pair_from_jax(jp, "cpu")
    R, t, nn = transforms(1, tp.n_data_padded, tp.model.shape[0], 3)
    R, t, nn = R[0], t[0], nn[0].astype(np.int32)
    want = jerr.score_transform(jp, jcfg, jnp.asarray(R), jnp.asarray(t),
                                jnp.asarray(nn))
    got = terr.score_transform_plain(tp, cfg, torch.from_numpy(R),
                                     torch.from_numpy(t), torch.from_numpy(nn))
    for f in want._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f == "incomp_count":
            assert int(g) == int(w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=f)
    assert float(terr.icp_chem_terms(tp, cfg, torch.from_numpy(nn))[3]) == \
        float(jerr.icp_chem_terms(jp, jcfg, jnp.asarray(nn))[3])
    assert int(terr.bnb_incompatibility_count_plain(
        tp, cfg, torch.from_numpy(R), torch.from_numpy(t))) == \
        int(jerr.bnb_incompatibility_count(jp, jcfg, jnp.asarray(R),
                                           jnp.asarray(t)))
    np.testing.assert_allclose(terr.initial_error_plain(tp, cfg).numpy(),
                               np.asarray(jerr.initial_error(jp, jcfg)),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# a numpy model of csrc/score.cu, one float32 rounding an operation
# ---------------------------------------------------------------------------

def warp_sum(terms):
    """ordered_sum's warp order over the last axis: lane l adds positions
    l, l + 32, ... from +0.0, then the butterfly at 16, 8, 4, 2, 1."""
    terms = np.asarray(terms, F32)
    n = terms.shape[-1]
    J = max(1, -(-n // 32))
    x = np.zeros(terms.shape[:-1] + (J * 32,), F32)
    x[..., :n] = terms
    x = x.reshape(terms.shape[:-1] + (J, 32))
    acc = np.zeros(terms.shape[:-1] + (32,), F32)
    for j in range(J):
        acc = acc + x[..., j, :]
    off = 16
    while off:
        acc = acc[..., :off] + acc[..., off:2 * off]
        off //= 2
    return acc[..., 0]


def dt_model(q, grid):
    """grid/lookup.py's dt_distance of points q (..., 3) as csrc/score.cu
    takes it: (the distance, the clamped voxel's flat index)."""
    consts = grid.consts.numpy()
    lo, scale, size = consts[:3], consts[3], int(consts[4])
    ri = np.trunc((q - lo) * scale + F32(0.5)).astype(np.int32)
    cl = np.clip(ri, 0, size - 1)
    vox = (cl[..., 2] * size + cl[..., 1]) * size + cl[..., 0]
    ex = np.where(ri < 0, ri, np.where(ri >= size, ri - size + 1, 0)
                  ).astype(F32)
    oob = ((ri < 0) | (ri >= size)).any(-1)
    s = (ex[..., 0] * ex[..., 0] + ex[..., 1] * ex[..., 1]) \
        + ex[..., 2] * ex[..., 2]
    d = grid.dist.numpy()[vox]
    return np.where(oob, d + np.sqrt(s) / scale, d), vox


def point_values(pair, R, t, mode):
    """Per row and point: (the distance, the BnB count's incompatibility),
    csrc/score.cu's step 1."""
    data = pair.data.numpy()
    if mode == terr.INITIAL:
        q = data[None]
    else:
        z = F32(0) + R[:, None, :, :] * data[None, :, None, :]
        q = ((z[..., 0] + z[..., 2]) + z[..., 1]) + t[:, None, :]
    d, vox = dt_model(q, pair.grid)
    cell = pair.grid.nearest_cell.numpy()[vox]
    bnb = (~pair.compat_table.numpy()[np.arange(len(data)), cell]) \
        & (pair.data_mask.numpy() != 0)
    return d, bnb


def kernel_model(pair, cfg, mode, R=None, t=None, nn=None):
    """csrc/score.cu's three routes in numpy float32."""
    d, bnb = point_values(pair, R, t, mode)
    if mode == terr.COUNT:
        return bnb.sum(-1).astype(np.int32)
    w, mask = pair.weights.numpy(), pair.data_mask.numpy()
    nd = d.shape[-1]
    trimmed, initial = cfg.doTrim, mode == terr.INITIAL
    v = d if trimmed and not initial else w * d
    if trimmed:
        v = np.where(mask > 0, v, F32(np.inf))
    counts = pair.counts.numpy()
    keep_below = F32(nd)
    if trimmed:
        dynamic = pair.dynamic_counts
        keep_below = counts[1] if dynamic else F32(pair.inlier_num)
        if dynamic or pair.inlier_num < nd:
            v = np.take_along_axis(v, np.argsort(v, -1, kind="stable"), -1)
    square = cfg.norm == 2 or (trimmed and not initial)
    fv = v * v if square else v
    geom = warp_sum(np.where(np.arange(nd, dtype=F32) < keep_below, fv,
                             F32(0)))
    nd_f = counts[0] if pair.dynamic_counts else F32(pair.n_data)
    if initial:
        err = geom[0]
        if cfg.regularization > 0:
            err = err + F32(cfg.regularization) * nd_f * nd_f
        if cfg.regularizationFPFH > 0:
            err = err + F32(cfg.regularizationFPFH * (800.0 * 800.0))
        if cfg.regularizationNeighbors > 0:
            six = F32(6.0) * nd_f
            err = err + F32(cfg.regularizationNeighbors) * six * six
        return err
    real = mask != 0
    compat = terr._compat(pair.device).numpy()
    dp, mp = pair.data_props.numpy(), pair.model_props.numpy()
    inc = ((~compat[dp[None], mp[nn]]) & real).sum(-1).astype(F32)
    zero = np.zeros_like(geom)
    nbr = incomp = fpfh = zero
    if cfg.regularizationNeighbors > 0:
        dn, mn = pair.data_nbrs.numpy(), pair.model_nbrs.numpy()
        nb = (np.abs(dn[None] - mn[nn]) * real).sum(-1).astype(F32)
        nbr = F32(cfg.regularizationNeighbors) * nb * nb
    if cfg.regularization > 0:
        incomp = F32(cfg.regularization) * inc * inc
    if cfg.regularizationFPFH > 0 and cfg.cfpfh != 0:
        fd, fm = pair.data_fpfh.numpy(), pair.model_fpfh.numpy()
        per = warp_sum(np.abs(fd[None] - fm[nn])) * mask
        fp = warp_sum(per) / nd_f
        fpfh = F32(cfg.regularizationFPFH) * fp * fp
    error = ((geom + nbr) + incomp) + fpfh
    bnb_count = bnb.sum(-1).astype(np.int32)
    return (error, geom, incomp, fpfh, nbr, bnb_count), inc


# case, rows, ties, a dynamic K (None: the pair's), the shift's scale
MODEL_CASES = {
    "l2, 4 rows": ("l2", 4, False, None, 0.05),
    "l1, 1 row": ("l1", 1, False, None, 0.05),
    "static trim, ties": ("static trim", 4, True, None, 0.05),
    "dynamic trim, ties": ("dynamic trim", 4, True, None, 0.05),
    "dynamic K = 0": ("dynamic trim", 4, False, 0.0, 0.05),
    "dynamic K = Nd": ("dynamic trim", 4, False, 64.0, 0.05),
    "cfpfh, 41 bins": ("cfpfh", 4, False, None, 0.05),
    "neighbours": ("neighbours", 4, False, None, 0.05),
    "padded": ("padded", 4, False, None, 0.05),
    "outside the grid": ("static trim", 4, False, None, 2.0),
    "far outside the grid": ("l2", 4, False, None, 2000.0),
}


def model_pair(name):
    case, K, ties, k, shift = MODEL_CASES[name]
    cfg, pair = torch_pair(case, dup=ties)
    if k is not None:
        counts = pair.counts.clone()
        counts[1] = k
        pair = dataclasses.replace(pair, counts=counts)
    return cfg, pair, K, shift


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_kernel_model_equals_plain_bit_for_bit(name):
    cfg, pair, K, shift = model_pair(name)
    R, t, nn = transforms(K, pair.n_data_padded, pair.model.shape[0], 5,
                          shift)
    tR, tt, tnn = map(torch.from_numpy, (R, t, nn))
    want = terr.score_transform_plain(pair, cfg, tR, tt, tnn)
    icp_inc = terr.icp_chem_terms(pair, cfg, tnn)[3]
    got, inc = kernel_model(pair, cfg, terr.FULL, R, t, nn)
    for f, g in zip(("error", "geom", "incomp_term", "fpfh_term",
                     "nbr_term"), got):
        np.testing.assert_array_equal(bits(g), bits(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got[5], want.incomp_count.numpy())
    np.testing.assert_array_equal(bits(inc), bits(icp_inc))
    np.testing.assert_array_equal(
        kernel_model(pair, cfg, terr.COUNT, R, t),
        terr.bnb_incompatibility_count_plain(pair, cfg, tR, tt).numpy())
    np.testing.assert_array_equal(
        bits(kernel_model(pair, cfg, terr.INITIAL)),
        bits(terr.initial_error_plain(pair, cfg)))


def test_kernel_model_covers_eight_bins_and_seeds():
    """cfpfh 3 (8 bins) with every chem term on: the initial error's
    three seeds and the terms' order, bit for bit."""
    cfg = GoICPConfig(**dict(BASE, cfpfh=3, regularizationFPFH=0.002,
                             regularizationNeighbors=0.001))
    raw = clouds(44, fpfh=True)
    pair = tprep.prepare_pair(*raw[:4], cfg, *raw[4:], device="cpu")
    assert pair.data_fpfh.shape[1] == 8
    R, t, nn = transforms(2, pair.n_data_padded, pair.model.shape[0], 6)
    tR, tt, tnn = map(torch.from_numpy, (R, t, nn))
    want = terr.score_transform_plain(pair, cfg, tR, tt, tnn)
    got, _ = kernel_model(pair, cfg, terr.FULL, R, t, nn)
    assert float(want.fpfh_term[0]) > 0 and float(want.nbr_term[0]) > 0
    np.testing.assert_array_equal(bits(got[0]), bits(want.error))
    np.testing.assert_array_equal(
        bits(kernel_model(pair, cfg, terr.INITIAL)),
        bits(terr.initial_error_plain(pair, cfg)))


def test_far_points_add_their_squares_in_order_as_jax():
    """Points thousands of voxels outside the grid, where the three
    squared excesses no longer add exactly in float32: dt_distance's
    extension is (a^2 + b^2) + c^2 (the numpy model) and equals the JAX
    package's dt_distance bit for bit."""
    import jax.numpy as jnp
    from goicp_tpu.grid import lookup as jlookup
    cfg, pair = torch_pair("l2")
    rng = np.random.default_rng(8)
    pts = rng.uniform(-2000.0, 2000.0, (512, 3)).astype(F32)
    g = pair.grid
    got = tlookup.dt_distance(torch.from_numpy(pts), g.dist, g.consts)
    np.testing.assert_array_equal(bits(got.numpy()),
                                  bits(dt_model(pts, g)[0]))
    s = (pts - g.consts.numpy()[:3]) * g.consts.numpy()[3]
    assert (np.abs(s) > 4096).any()      # squares beyond 2^24
    jd = jlookup.dt_distance(jnp.asarray(pts), jnp.asarray(g.dist.numpy()),
                             jnp.asarray(g.consts.numpy()))
    np.testing.assert_array_equal(bits(got.numpy()), bits(np.asarray(jd)))


def test_cpu_tensors_take_the_plain_bodies_and_launch_nothing():
    cfg, pair = torch_pair("dynamic trim")
    R, t, nn = map(torch.from_numpy, transforms(
        3, pair.n_data_padded, pair.model.shape[0], 9))
    before = terr.score_kernel.launches
    sc, inc = terr.rescore(pair, cfg, R, t, nn)
    want = terr.score_transform_plain(pair, cfg, R, t, nn)
    for f in want._fields:
        assert torch.equal(getattr(sc, f), getattr(want, f)), f
    assert torch.equal(inc, terr.icp_chem_terms(pair, cfg, nn)[3])
    assert torch.equal(terr.score_transform(pair, cfg, R, t, nn).error,
                       want.error)
    assert torch.equal(terr.bnb_incompatibility_count(pair, cfg, R[0], t[0]),
                       terr.bnb_incompatibility_count_plain(pair, cfg, R[0],
                                                            t[0]))
    assert torch.equal(terr.initial_error(pair, cfg),
                       terr.initial_error_plain(pair, cfg))
    assert terr.score_kernel.launches == before


# ---------------------------------------------------------------------------
# on the card: the kernel vs the plain bodies
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_kernel_equals_plain_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, pair, K, shift = model_pair(name)
    R, t, nn = map(torch.from_numpy, transforms(
        K, pair.n_data_padded, pair.model.shape[0], 5, shift))
    card = pair.to("cuda")
    cR, ct, cnn = R.cuda(), t.cuda(), nn.cuda()
    sc, inc = terr.rescore(card, cfg, cR, ct, cnn)
    want = terr.score_transform_plain(card, cfg, cR, ct, cnn)
    for f in want._fields:
        assert torch.equal(getattr(sc, f).view(torch.int32),
                           getattr(want, f).view(torch.int32)), f
    assert torch.equal(inc, terr.icp_chem_terms(card, cfg, cnn)[3])
    assert torch.equal(terr.bnb_incompatibility_count(card, cfg, cR, ct),
                       terr.bnb_incompatibility_count_plain(card, cfg, cR,
                                                            ct))
    assert torch.equal(terr.initial_error(card, cfg).view(torch.int32),
                       terr.initial_error_plain(card, cfg).view(torch.int32))
