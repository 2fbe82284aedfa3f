"""Port preparation (goicp_tpu_torch/pipeline/prepare.py, bench pools) vs
the JAX package: prepared arrays, shape buckets, pair_from_jax, pools."""

import dataclasses

import numpy as np
import pytest
import torch

from goicp_tpu.bench import measure as jmeasure
from goicp_tpu.config import GoICPConfig
from goicp_tpu.pipeline import prepare as jprep
from goicp_tpu_torch.bench import measure as tmeasure
from goicp_tpu_torch.pipeline import prepare as tprep

_LEAVES = [f.name for f in dataclasses.fields(tprep.PairData)
           if f.type == "torch.Tensor"]
_GRID = ("dist", "nearest_cell", "cell_color", "cell_mask", "cell_points",
         "cell_count", "cell_coords", "consts")
_STATIC = ("inlier_num", "n_data", "n_model", "fused_chem", "dynamic_counts")


def _assert_same(tp, jp):
    for f in _STATIC:
        assert getattr(tp, f) == getattr(jp, f), f
    for f in _LEAVES:
        a = np.asarray(getattr(jp, f))
        b = getattr(tp, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f in ("fpfh_table", "fpfh_voxel"):
            # L1 sums over the selected descriptor bins: XLA and torch add
            # them in different orders (last-bit differences only)
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    for f in _GRID:
        np.testing.assert_array_equal(getattr(tp.grid, f).numpy(),
                                      np.asarray(getattr(jp.grid, f)),
                                      err_msg=f)
    assert tp.grid.n_cells == jp.grid.n_cells
    assert vars(tp.grid.geom) == vars(jp.grid.geom)


def _inputs(seed, n=37, m=41, fpfh=False):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.7, 0.7, size=(n, 3))
    tgt = rng.uniform(-0.7, 0.7, size=(m, 3))
    sp = rng.integers(0, 9, size=n).astype(np.int32)
    tp = rng.integers(0, 9, size=m).astype(np.int32)
    kw = {}
    if fpfh:
        kw = dict(source_fpfh=rng.uniform(0, 50, size=(n, 41)),
                  target_fpfh=rng.uniform(0, 50, size=(m, 41)))
    return (src, tgt, sp, tp), kw


@pytest.mark.parametrize("case", [
    dict(cfg={}, pad={}),
    dict(cfg=dict(trimFraction=0.2), pad={}),
    dict(cfg={}, pad=dict(pad_data_to=64, pad_model_to=64, pad_cells=64,
                          pad_points=8)),
    dict(cfg=dict(trimFraction=0.1, regularizationNeighbors=0.001),
         pad=dict(bucket=True)),
    dict(cfg=dict(cfpfh=1, regularizationFPFH=0.001, distTransSize=10),
         pad=dict(pad_data_to=48), fpfh=True),
    dict(cfg=dict(regularization=0.0, ponderation=0), pad={}),
])
@pytest.mark.parametrize("dynamic", [False, True])
def test_prepare_pair_equals_jax(case, dynamic):
    cfg = GoICPConfig(**{"distTransSize": 12, **case["cfg"]})
    args, kw = _inputs(3, fpfh=case.get("fpfh", False))
    jp = jprep.prepare_pair(*args, cfg, **kw, **case["pad"])
    tp = tprep.prepare_pair(*args, cfg, **kw, **case["pad"], device="cpu")
    if dynamic:
        jp, tp = jprep.make_count_dynamic(jp), tprep.make_count_dynamic(tp)
    _assert_same(tp, jp)
    assert tp.padded == jp.padded


def test_pair_from_jax_round_trips():
    cfg = GoICPConfig(distTransSize=12, trimFraction=0.1)
    args, _ = _inputs(5)
    jp = jprep.make_count_dynamic(jprep.prepare_pair(*args, cfg,
                                                     bucket=True))
    _assert_same(tprep.pair_from_jax(jp, "cpu"), jp)
    moved = tprep.pair_from_jax(jp, "cpu").to("cpu")
    assert moved.grid.dist.device.type == "cpu"


def test_bucket_dims_and_plan_equal_jax():
    cfg = GoICPConfig()
    pool = tmeasure.synthetic_pool(12, seed=7)
    dims_t, dims_j = [], []
    for e in pool:
        data, model, _, _ = tmeasure._normalized_synthetic(e)
        dims_t.append(tprep.bucket_dims(model, len(data), len(model), cfg))
        dims_j.append(jprep.bucket_dims(model, len(data), len(model), cfg))
    assert dims_t == dims_j
    for kb in (1, 2, 3, 4):
        assert tprep.plan_buckets(dims_t, max_buckets=kb) == \
            jprep.plan_buckets(dims_j, max_buckets=kb)


@pytest.mark.parametrize("trimmed", [False, True])
def test_pools_equal_jax(trimmed):
    if trimmed:
        got = tmeasure.synthetic_pool_trimmed(32, seed=23)
        want = jmeasure.synthetic_pool_trimmed(32, seed=23)
    else:
        got = tmeasure.synthetic_pool(64, seed=7)
        want = jmeasure.synthetic_pool(64, seed=7)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
    for g, w in zip(got[:4], want[:4]):
        for a, b in zip(tmeasure._normalized_synthetic(g),
                        jmeasure._normalized_synthetic(w)):
            np.testing.assert_array_equal(a, b)
    base = GoICPConfig()
    assert tmeasure.bench_shape(base) == jmeasure.bench_shape(base)
    assert tmeasure.TRIM_FRACTION == jmeasure.TRIM_FRACTION


def test_prepare_on_device_argument():
    cfg = GoICPConfig(distTransSize=10)
    args, _ = _inputs(7)
    p = tprep.prepare_pair(*args, cfg, device=torch.device("cpu"))
    assert p.device.type == "cpu" and p.grid.consts.device.type == "cpu"


def _small_raw(n_pairs=5, seed=41):
    rng = np.random.default_rng(seed)
    raw = []
    for _ in range(n_pairs):
        m = int(rng.integers(30, 70))
        n = int(rng.integers(20, m + 1))
        raw.append((rng.uniform(-0.7, 0.7, size=(n, 3)),
                    rng.uniform(-0.7, 0.7, size=(m, 3)),
                    rng.integers(0, 9, size=n).astype(np.int32),
                    rng.integers(0, 9, size=m).astype(np.int32)))
    return raw


def test_bucket_and_prepare_equals_jax_and_stacks():
    """One pool-max bucket: every pair equals the JAX package's, and the
    pairs stack along a pair axis (dist/mesh.stack_pairs) leaf by leaf."""
    from goicp_tpu_torch.dist.mesh import stack_pairs
    cfg = GoICPConfig(distTransSize=12, trimFraction=0.1)
    raw = _small_raw()
    jpairs = jmeasure._bucket_and_prepare(raw, cfg)
    tpairs = tmeasure._bucket_and_prepare(raw, cfg, device="cpu")
    assert len({p.data.shape for p in tpairs}) == 1
    for tp, jp in zip(tpairs, jpairs):
        assert tp.dynamic_counts and tp.device.type == "cpu"
        _assert_same(tp, jp)
    stacked = stack_pairs(tpairs)
    assert stacked.data.shape == (5,) + tuple(tpairs[0].data.shape)
    for f in _LEAVES:
        for i, tp in enumerate(tpairs):
            assert torch.equal(getattr(stacked, f)[i], getattr(tp, f)), f
    for f in _GRID:
        assert torch.equal(getattr(stacked.grid, f)[3],
                           getattr(tpairs[3].grid, f)), f


def test_bucket_and_prepare_multi_and_reassemble():
    """Shape buckets partition the pool as the JAX package's plan does, and
    _reassemble undoes the partition."""
    from goicp_tpu_torch.search.device_engine import DeviceResult
    cfg = GoICPConfig(distTransSize=12)
    raw = _small_raw(n_pairs=9, seed=43)
    jb = jmeasure._bucket_and_prepare_multi(raw, cfg, max_buckets=3)
    tb = tmeasure._bucket_and_prepare_multi(raw, cfg, max_buckets=3,
                                            device="cpu")
    assert [idxs for _, idxs in tb] == [idxs for _, idxs in jb]
    assert sorted(i for _, idxs in tb for i in idxs) == list(range(9))
    for (tps, _), (jps, _) in zip(tb, jb):
        for tp, jp in zip(tps, jps):
            _assert_same(tp, jp)
    outs = []
    for _, idxs in tb:
        cols = {f: np.asarray(idxs, np.float32) * (k + 1)
                for k, f in enumerate(DeviceResult._fields)}
        outs.append((idxs, DeviceResult(**cols)))
    whole = tmeasure._reassemble(outs, 9)
    np.testing.assert_array_equal(whole.error, np.arange(9, dtype=np.float32))
    np.testing.assert_array_equal(whole.t, 3 * np.arange(9, dtype=np.float32))


def test_prepare_defaults_to_the_default_device():
    """device=None means the card: cuda:0 where there is one, else an
    error asking for device="cpu" (never a silent CPU run)."""
    args, kw = _inputs(5)
    cfg = GoICPConfig(distTransSize=10)
    jp = jprep.prepare_pair(*args, cfg)
    if torch.cuda.is_available():
        assert tprep.prepare_pair(*args, cfg).device == torch.device("cuda:0")
        assert tprep.pair_from_jax(jp).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tprep.prepare_pair(*args, cfg)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tprep.pair_from_jax(jp)
    assert tprep.pair_from_jax(jp, "cpu").device.type == "cpu"
