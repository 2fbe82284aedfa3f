"""Port ICP and scoring (goicp_tpu_torch/icp, bounds/error.py) vs the JAX
package, at atol 1e-5: NN correspondences, Kabsch (degenerate H too),
icp_run in every mode, score_transform and initial_error."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goicp_tpu.bounds import error as jerr
from goicp_tpu.config import GoICPConfig
from goicp_tpu.geom.rotation import rodrigues_np
from goicp_tpu.icp import icp as jicp
from goicp_tpu.pipeline import prepare as jprep
from goicp_tpu_torch.bounds import error as terr
from goicp_tpu_torch.geom import rotation as trot
from goicp_tpu_torch.icp import icp as ticp
from goicp_tpu_torch.pipeline.prepare import pair_from_jax

# small torch ops in a loop: intra-op threads only contend with the
# parallel test workers (see test_torch_device_engine.py)
torch.set_num_threads(1)

TOL = dict(rtol=0, atol=1e-5)


def _clouds(seed, n=48, m=56, noise=0.0, outliers=0):
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.7, 0.7, size=(m, 3))
    R = rodrigues_np(rng.uniform(-0.3, 0.3, 3))
    t = rng.uniform(-0.05, 0.05, 3)
    data = (model[:n] - t) @ R + rng.normal(0, noise, size=(n, 3))
    if outliers:
        data[:outliers] = rng.uniform(-0.9, 0.9, size=(outliers, 3))
    return data.astype(np.float32), model.astype(np.float32)


def test_rodrigues_matches_jax():
    from goicp_tpu.geom.rotation import rodrigues
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.uniform(-3, 3, (64, 3)), np.zeros((1, 3))]
                       ).astype(np.float32)
    np.testing.assert_allclose(trot.rodrigues(torch.as_tensor(v)).numpy(),
                               np.asarray(rodrigues(jnp.asarray(v))),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(trot.rodrigues_np(v[3]), rodrigues_np(v[3]))


def test_nn_correspondences_match_jax():
    data, model = _clouds(1, noise=0.01)
    ij, dj = jicp.nn_correspondences(jnp.asarray(data), jnp.asarray(model))
    it, dt = ticp.nn_correspondences(torch.as_tensor(data),
                                     torch.as_tensor(model))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)


@pytest.mark.parametrize("kind", ["random", "zero", "rank1", "rank2",
                                  "reflection"])
def test_kabsch_matches_jax(kind):
    rng = np.random.default_rng(3)
    if kind == "random":
        q_d = rng.normal(size=(40, 3))
        q_m = q_d @ rodrigues_np(rng.uniform(-2, 2, 3)).T
        H = q_d.T @ q_m
    elif kind == "zero":
        H = np.zeros((3, 3))
    elif kind == "rank1":
        H = np.outer(rng.normal(size=3), rng.normal(size=3))
    elif kind == "rank2":
        H = rng.normal(size=(3, 2)) @ rng.normal(size=(2, 3))
    else:
        H = np.diag([1.0, 2.0, -3.0]) @ rodrigues_np(rng.uniform(-1, 1, 3))
    H = H.astype(np.float32)
    want = np.asarray(jicp.kabsch_from_H(jnp.asarray(H)))
    got = ticp.kabsch_from_H(torch.as_tensor(H)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if kind == "random":
        qd = torch.as_tensor(q_d, dtype=torch.float32)
        qm = torch.as_tensor(q_m, dtype=torch.float32)
        np.testing.assert_allclose(
            ticp.kabsch(qd, qm).numpy(),
            np.asarray(jicp.kabsch(jnp.asarray(qd.numpy()),
                                   jnp.asarray(qm.numpy()))), **TOL)


def _run_both(data, model, R0, t0, enabled=None, **kw):
    """JAX icp_run vmapped over the K starts, and the port's batched run."""
    jdata, jmodel = jnp.asarray(data), jnp.asarray(model)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    if "count" in jkw and jkw["count"] is not None:
        jkw["count"] = jnp.float32(kw["count"])

    def one(R, t, en):
        return jicp.icp_run(jdata, jmodel, R, t, enabled=en, **jkw)

    en = np.ones(len(R0), bool) if enabled is None else enabled
    want = jax.vmap(one)(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(en))
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    if tkw.get("count") is not None:
        tkw["count"] = torch.tensor(float(kw["count"]))
    got = ticp.icp_run(torch.as_tensor(data), torch.as_tensor(model),
                       torch.as_tensor(R0), torch.as_tensor(t0),
                       enabled=None if enabled is None
                       else torch.as_tensor(enabled), **tkw)
    return got, want


def test_jacobi_svd3_bits_equal_jax_op_by_op():
    """The Jacobi SVD's three square roots (tau's, c's, sigma's) round
    correctly, so U, sigma and V equal the JAX package's _jacobi_svd3 run
    op by op on XLA:CPU bit for bit.  torch.sqrt of a float32 CPU tensor
    is one ulp off for some of these inputs in some torch builds, and then
    a few percent of the 256 matrices differ."""
    rng = np.random.default_rng(17)
    H = rng.normal(size=(256, 3, 3)).astype(np.float32)
    Hn = H / np.abs(H).max(axis=(1, 2), keepdims=True)
    want = jicp._jacobi_svd3(jnp.asarray(Hn))
    got = ticp._jacobi_svd3(torch.from_numpy(Hn))
    for name, g, w in zip(("U", "sigma", "V"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)


@pytest.mark.parametrize("mode", ["plain", "trim", "mask", "count",
                                  "dynamic_trim", "enabled"])
def test_icp_run_matches_jax(mode):
    data, model = _clouds(5, noise=0.003, outliers=6)
    n = len(data)
    kw = dict(inlier_num=n, max_iter=60, err_diff=1e-6)
    enabled = None
    if mode == "trim":
        kw["inlier_num"] = int(n * 0.8)
    if mode in ("mask", "count", "dynamic_trim"):
        pad = 16
        data = np.vstack([data, np.full((pad, 3), 4.0e3, np.float32)])
        mask = np.concatenate([np.ones(n), np.zeros(pad)]).astype(np.float32)
        kw.update(inlier_num=n + pad if mode != "mask" else n,
                  data_mask=mask)
        if mode == "count":
            kw["count"] = float(n)
        if mode == "dynamic_trim":
            kw.update(count=float(int(n * 0.8)), dynamic_trim=True)
    if mode == "enabled":
        enabled = np.array([True, False, True])
    rng = np.random.default_rng(9)
    R0 = np.stack([rodrigues_np(rng.uniform(-0.2, 0.2, 3))
                   for _ in range(3)]).astype(np.float32)
    t0 = rng.uniform(-0.02, 0.02, (3, 3)).astype(np.float32)
    got, want = _run_both(data, model, R0, t0, enabled=enabled, **kw)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.nn_idx.numpy(),
                                  np.asarray(want.nn_idx))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), **TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), **TOL)
    np.testing.assert_allclose(got.err.numpy(), np.asarray(want.err),
                               rtol=1e-5, atol=1e-6)
    if mode == "enabled":
        assert int(got.iters[1]) == 0 and float(got.err[1]) == -1.0


@pytest.mark.parametrize("trim,dynamic", [(0.0, False), (0.15, False),
                                          (0.15, True), (0.0, True)])
def test_scoring_matches_jax(trim, dynamic):
    cfg = GoICPConfig(regularization=0.0005, ponderation=1,
                      distTransSize=12, trimFraction=trim)
    data, model = _clouds(7, noise=0.01)
    rng = np.random.default_rng(2)
    props = rng.integers(0, 9, len(model)).astype(np.int32)
    jp = jprep.prepare_pair(data, model, props[:len(data)], props, cfg,
                            pad_data_to=64)
    if dynamic:
        jp = jprep.make_count_dynamic(jp)
    tp = pair_from_jax(jp, "cpu")
    np.testing.assert_allclose(terr.initial_error(tp, cfg).numpy(),
                               np.asarray(jerr.initial_error(jp, cfg)),
                               rtol=1e-6, atol=1e-5)
    R = rodrigues_np(rng.uniform(-0.2, 0.2, 3)).astype(np.float32)
    t = rng.uniform(-0.03, 0.03, 3).astype(np.float32)
    nn = rng.integers(0, len(model), jp.n_data_padded).astype(np.int32)
    want = jerr.score_transform(jp, cfg, jnp.asarray(R), jnp.asarray(t),
                                jnp.asarray(nn))
    got = terr.score_transform(tp, cfg, torch.as_tensor(R),
                               torch.as_tensor(t), torch.as_tensor(nn))
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-5, err_msg=f)
    bc, res, sc, inc = terr.refine_transform(tp, cfg, torch.as_tensor(R),
                                             torch.as_tensor(t), max_iter=40)
    jbc, jres, jsc, jinc = jerr.refine_transform(
        jp, cfg, jnp.asarray(R), jnp.asarray(t), max_iter=40)
    assert int(bc) == int(jbc) and float(inc[0]) == float(jinc)
    np.testing.assert_allclose(res.R[0].numpy(), np.asarray(jres.R), **TOL)
    np.testing.assert_allclose(sc.error[0].numpy(), np.asarray(jsc.error),
                               rtol=1e-6, atol=1e-5)


def test_scoring_batched_rows_equal_single():
    cfg = GoICPConfig(distTransSize=12, trimFraction=0.1)
    data, model = _clouds(8)
    props = np.zeros(len(model), np.int32)
    tp = pair_from_jax(jprep.prepare_pair(data, model, props[:len(data)],
                                          props, cfg), "cpu")
    rng = np.random.default_rng(4)
    Rs = torch.as_tensor(np.stack([rodrigues_np(rng.uniform(-1, 1, 3))
                                   for _ in range(3)]), dtype=torch.float32)
    ts = torch.as_tensor(rng.uniform(-0.1, 0.1, (3, 3)), dtype=torch.float32)
    nn = torch.zeros((3, tp.n_data_padded), dtype=torch.int64)
    batch = terr.score_transform(tp, cfg, Rs, ts, nn)
    for i in range(3):
        one = terr.score_transform(tp, cfg, Rs[i], ts[i], nn[i])
        for f in one._fields:
            assert torch.equal(getattr(batch, f)[i], getattr(one, f)), f
    assert dataclasses.is_dataclass(tp)
