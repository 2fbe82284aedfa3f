"""Port grid (goicp_tpu_torch/grid) vs the JAX package's grid: every Grid
field equal, the C-truncating ROUND, and the DT lookups."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from goicp_tpu.grid import edt as jedt
from goicp_tpu.grid import lookup as jlookup
from goicp_tpu_torch.grid import edt as tedt
from goicp_tpu_torch.grid import lookup as tlookup

_FIELDS = ("dist", "nearest_cell", "cell_color", "cell_mask", "cell_points",
           "cell_count", "cell_coords", "consts")


def _random_cloud(n=60, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.8, 0.8, size=(n, 3))
    props = rng.integers(0, 9, size=n).astype(np.int32)
    return pts, props


def test_round_ref_truncates_toward_zero():
    # ROUND(x) = int(x+0.5) with C trunc-toward-zero: -1.2 -> 0, not -1
    xs = np.array([-1.6, -1.5, -1.2, -0.7, -0.5, -0.4, 0.0, 0.4, 0.5, 1.49,
                   2.5], np.float32)
    expect = np.array([int(x + 0.5) for x in xs.astype(np.float64)])
    np.testing.assert_array_equal(tedt.round_ref_np(xs), expect)
    got = tedt.round_ref(torch.as_tensor(xs)).numpy()
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(
        got, np.asarray(jedt.round_ref(jnp.asarray(xs))))


@pytest.mark.parametrize("n,seed,size,pad", [
    (50, 1, 12, None), (30, 2, 16, None), (40, 3, 14, (64, 8)),
    (25, 5, 12, (40, 4)), (60, 0, 20, None), (3, 0, 8, None)])
def test_grid_fields_equal_jax(n, seed, size, pad):
    pts, props = _random_cloud(n, seed)
    if n == 3:   # two points share a voxel, the third alone
        pts = np.array([[0.0, 0.0, 0.0], [0.001, 0.0, 0.0], [0.5, 0.5, 0.5]])
        props = np.array([2, 2, 5], np.int32)
    kw = dict(pad_cells=pad[0], pad_points=pad[1]) if pad else {}
    gj = jedt.build_grid(pts, props, size=size, expand_factor=2.0, **kw)
    gt = tedt.build_grid(pts, props, size=size, expand_factor=2.0,
                         device="cpu", **kw)
    assert gt.n_cells == gj.n_cells
    assert vars(gt.geom) == vars(gj.geom)
    for f in _FIELDS:
        a = np.asarray(getattr(gj, f))
        b = getattr(gt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("seed,size", [(3, 14), (4, 10), (5, 12)])
def test_lookups_equal_jax(seed, size):
    pts, props = _random_cloud(40, seed)
    gj = jedt.build_grid(pts, props, size=size, expand_factor=2.0)
    gt = tedt.build_grid(pts, props, size=size, expand_factor=2.0,
                         device="cpu")
    rng = np.random.default_rng(seed)
    # in-bounds, model points, and far out-of-bounds queries
    q = np.concatenate([rng.uniform(-1.0, 1.0, size=(200, 3)), pts,
                        rng.uniform(-4.0, 4.0, size=(100, 3))]
                       ).astype(np.float32)
    qt = torch.as_tensor(q)
    dj = np.asarray(jlookup.dt_distance(jnp.asarray(q), gj.dist, gj.consts))
    dt = tlookup.dt_distance(qt, gt.dist, gt.consts).numpy()
    np.testing.assert_array_equal(dt, dj)
    cj = np.asarray(jlookup.nearest_cell_id(jnp.asarray(q), gj.nearest_cell,
                                            gj.consts))
    ct = tlookup.nearest_cell_id(qt, gt.nearest_cell, gt.consts).numpy()
    np.testing.assert_array_equal(ct, cj)
    rj, kj = jlookup.voxel_indices(jnp.asarray(q), gj.consts)
    rt, kt = tlookup.voxel_indices(qt, gt.consts)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))


def test_edt_matches_brute_force():
    pts, props = _random_cloud(50, 1)
    size = 12
    g = tedt.build_grid(pts, props, size=size, expand_factor=2.0,
                        device="cpu")
    occ = g.cell_coords.numpy()[: g.n_cells].astype(np.float64)
    flat = np.arange(size ** 3)
    voxels = np.stack([flat % size, (flat // size) % size,
                       flat // (size * size)], axis=1).astype(np.float64)
    d = np.linalg.norm(voxels[:, None, :] - occ[None, :, :], axis=2)
    np.testing.assert_allclose(g.dist.numpy(), d.min(axis=1) / g.geom.scale,
                               atol=1e-5)
    # first-minimum tie-break: the smallest index among the nearest cells
    d2 = ((voxels[:, None, :] - occ[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(g.nearest_cell.numpy(), d2.argmin(axis=1))


def test_build_grid_defaults_to_the_default_device():
    """device=None means the card: cuda:0 where there is one, else an
    error asking for device="cpu"."""
    pts, props = _random_cloud(20, 2)
    if torch.cuda.is_available():
        g = tedt.build_grid(pts, props, size=8, expand_factor=2.0)
        assert g.nearest_cell.device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tedt.build_grid(pts, props, size=8, expand_factor=2.0)
        g = tedt.build_grid(pts, props, size=8, expand_factor=2.0,
                            device="cpu")
    assert g.nearest_cell.dtype == torch.int32


def test_exact_sqrt_is_correctly_rounded():
    """The port's float32 square roots equal numpy's correctly rounded ones
    (and so XLA's) bit for bit: the helper over every integer below
    3 * 1024^2 (the largest squared voxel distance at S <= 1024), and the
    EDT's `dist` and the out-of-bounds extension over the squared distances
    of a grid with one occupied cell in a corner."""
    ints = np.arange(3 * 1024 ** 2, dtype=np.float32)
    np.testing.assert_array_equal(
        tedt.exact_sqrt(torch.as_tensor(ints)).numpy(), np.sqrt(ints))
    size = 40
    dist, nearest = tedt._edt_fields(
        torch.zeros((1, 3), dtype=torch.int32), size)
    flat = np.arange(size ** 3)
    d2 = ((flat % size) ** 2 + ((flat // size) % size) ** 2
          + (flat // size ** 2) ** 2).astype(np.float32)
    assert (nearest.numpy() == 0).all()
    np.testing.assert_array_equal(dist.numpy(), np.sqrt(d2))
    raw = torch.as_tensor(np.stack([flat % size - size, -(flat // size % size),
                                    flat // size ** 2 + size], axis=1),
                          dtype=torch.int32)
    consts = torch.tensor([0.0, 0.0, 0.0, 1.0, float(size)])
    oob, ext = tlookup.oob_extension(raw, consts)
    a = (raw[:, 0].numpy() - 0).astype(np.float32)
    b = raw[:, 1].numpy().astype(np.float32)
    c = (raw[:, 2].numpy() - size + 1).astype(np.float32)
    assert bool(oob.all())
    np.testing.assert_array_equal(ext.numpy(), np.sqrt(a * a + b * b + c * c))
