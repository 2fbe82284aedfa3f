"""L1-norm (`norm=1`) parity: the five cases of tests/test_l1_norm.py, each
with the port held to the JAX package on the same seeded numpy inputs and
keeping the case's own property.

Under norm 1 every bound and score sums d instead of d^2.  The grids are
cut to S = 12 (the JAX file's 24 costs the CPU run more and adds nothing
to parity).  Tolerances: untrimmed bound sums atol 1e-5 (the same per-point
distances summed in another order), trimmed ones rtol 1e-5 / atol 1e-4 (the
same inlier set), scores rtol 1e-6, registrations error within 1e-5 and
search counters equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goicp_tpu.bounds import error as jerr
from goicp_tpu.bounds import evaluate as jev
from goicp_tpu.config import GoICPConfig as JConfig
from goicp_tpu.icp.icp import icp_run as jicp_run
from goicp_tpu.pipeline.prepare import prepare_pair as jprepare
from goicp_tpu.search import outer as jouter
from goicp_tpu.search.device_engine import register_device as jregister
from goicp_tpu_torch.bounds import error as terr
from goicp_tpu_torch.bounds import evaluate as tev
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.geom.rotation import rodrigues_np
from goicp_tpu_torch.grid.lookup import dt_distance
from goicp_tpu_torch.icp.icp import icp_run
from goicp_tpu_torch.pipeline.prepare import prepare_pair
from goicp_tpu_torch.search import outer as touter
from goicp_tpu_torch.search.device_engine import register_device
from tests.test_l1_norm import _L1, _synth

torch.set_num_threads(1)

UNTRIMMED = dict(rtol=0, atol=1e-5)
TRIMMED = dict(rtol=1e-5, atol=1e-4)
_KW = dict(_L1, distTransSize=12)


def _both(data, model, props, **kw):
    """(JAX cfg, JAX pair, port cfg, port pair) of one seeded pair, each
    prepared by its own package."""
    jcfg, cfg = JConfig(**_KW, **kw), GoICPConfig(**_KW, **kw)
    assert cfg.norm == 1
    return (jcfg, jprepare(data, model, props, props, jcfg), cfg,
            prepare_pair(data, model, props, props, cfg, device="cpu"))


def _f32(a):
    return np.asarray(a, np.float32)


def _node(w=0.125):
    node = np.array([0.05, -0.12, 0.02])
    return node, _f32(node + w / 2)[None, None], np.full((1, 1), w,
                                                          np.float32)


def test_l1_bounds_valid():
    """ub equals the L1 error at the cube center and lb lower-bounds it
    at every translation inside the cube, in the port; both equal JAX's."""
    data, model, props, R, _ = _synth(40, 2)
    jcfg, jp, cfg, tp = _both(data, model, props)
    pts = _f32(data @ R.T)[None]
    node, center, widths = _node()
    want = jev.geometric_bounds(jp, jcfg, jnp.asarray(pts),
                                jnp.asarray(center), jnp.asarray(widths),
                                None)
    got = tev.geometric_bounds(tp, cfg, torch.from_numpy(pts),
                               torch.from_numpy(center),
                               torch.from_numpy(widths), None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **UNTRIMMED)
    ub, lb = float(got[0][0, 0]), float(got[1][0, 0])

    def l1(t):
        p = torch.from_numpy(pts[0] + _f32(t))
        return float(torch.sum(dt_distance(p, tp.grid.dist, tp.grid.consts)))
    assert ub == pytest.approx(l1(center[0, 0]), rel=1e-5)
    rng = np.random.default_rng(0)
    for _ in range(10):
        assert lb <= l1(node + rng.uniform(0, 0.125, 3)) + 1e-4


def test_l1_bounds_valid_with_uncertainty_and_trim():
    """Trimmed, with rotation uncertainty: the fused evaluator's three
    bounds equal JAX's, and its lb lower-bounds the trimmed L1 error of
    every rotation inside the cube at every translation inside the node."""
    data, model, props, *_ = _synth(50, 7)
    jcfg, jp, cfg, tp = _both(data, model, props, trimFraction=0.2)
    k = tp.inlier_num
    assert k < tp.n_data and k == jp.inlier_num
    rot_center, rw = np.array([0.4, -0.3, 0.2]), 0.25
    pts = _f32(data @ rodrigues_np(rot_center).T)[None]
    node, center, widths = _node()
    jmrd = jev.rot_uncertainty(jnp.asarray([rw], jnp.float32), jp.norm_data)
    mrd = tev.rot_uncertainty(torch.tensor([rw]), tp.norm_data)
    np.testing.assert_allclose(mrd.numpy(), np.asarray(jmrd), rtol=1e-6)
    want = jev.geometric_bounds_fused(jp, jcfg, jnp.asarray(pts),
                                      jnp.asarray(center),
                                      jnp.asarray(widths), jmrd)
    got = tev.geometric_bounds_fused(tp, cfg, torch.from_numpy(pts),
                                     torch.from_numpy(center),
                                     torch.from_numpy(widths), mrd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TRIMMED)
    lb = float(got[2][0, 0])
    rng = np.random.default_rng(3)
    for _ in range(10):
        rr = rot_center + rng.uniform(-rw / 2, rw / 2, size=3)
        tt = node + rng.uniform(0, 0.125, size=3)
        p = torch.from_numpy(_f32(data @ rodrigues_np(rr).T + tt))
        d = torch.sort(dt_distance(p, tp.grid.dist, tp.grid.consts)).values
        assert lb <= float(d[:k].sum()) + 1e-4


def test_l1_score_and_initial_error():
    """initial_error and score_transform at the identity sum d (L1), in
    both packages."""
    data, model, props, *_ = _synth(30, 5)
    jcfg, jp, cfg, tp = _both(data, model, props)
    expect = float(torch.sum(dt_distance(tp.data, tp.grid.dist,
                                         tp.grid.consts)))
    init = float(terr.initial_error(tp, cfg))
    assert init == pytest.approx(expect, rel=1e-6)
    assert init == pytest.approx(float(jerr.initial_error(jp, jcfg)),
                                 rel=1e-6)
    eye, zero = torch.eye(3), torch.zeros(3)
    res = icp_run(tp.data, tp.model, eye[None], zero[None],
                  inlier_num=tp.inlier_num, max_iter=1, err_diff=1e-8)
    jres = jicp_run(jp.data, jp.model, jnp.eye(3), jnp.zeros(3),
                    inlier_num=jp.inlier_num, max_iter=1, err_diff=1e-8)
    np.testing.assert_array_equal(res.nn_idx[0].numpy(),
                                  np.asarray(jres.nn_idx))
    sc = terr.score_transform(tp, cfg, eye, zero, res.nn_idx[0])
    jsc = jerr.score_transform(jp, jcfg, jnp.eye(3), jnp.zeros(3),
                               jres.nn_idx)
    assert float(sc.geom) == pytest.approx(expect, rel=1e-6)
    for f in ("error", "geom", "incomp_term", "fpfh_term", "nbr_term"):
        assert float(getattr(sc, f)) == pytest.approx(
            float(getattr(jsc, f)), rel=1e-6, abs=1e-6), f


@pytest.fixture(scope="module")
def hosts():
    """The host engine of both packages on one planted pair."""
    data, model, props, R, tv = _synth(48, 9)
    jcfg, jp, cfg, tp = _both(data, model, props)
    return dict(jcfg=jcfg, jp=jp, cfg=cfg, tp=tp, R=R, tv=tv,
                want=jouter.register(jp, jcfg), got=touter.register(tp, cfg))


def test_l1_register_synthetic_global(hosts):
    """The host engine under L1 recovers the planted global transform, with
    JAX's search counters."""
    got, want = hosts["got"], hosts["want"]
    assert got.converged and got.error < 1e-2
    np.testing.assert_allclose(got.R, hosts["R"], atol=1e-3)
    np.testing.assert_allclose(got.t, hosts["tv"], atol=1e-3)
    assert abs(got.error - want.error) <= 1e-5
    for k in ("outer_steps", "bound_evals", "icp_runs", "converged",
              "optComp"):
        assert getattr(got, k) == getattr(want, k), k


def test_l1_device_engine_matches_host(hosts):
    """register_device agrees with the host engine under L1 (both at the
    planted optimum) and with JAX's register_device in every counter."""
    tp, cfg = hosts["tp"], hosts["cfg"]
    dev = register_device(tp, cfg)
    want = jax.device_get(jregister(hosts["jp"], hosts["jcfg"]))
    assert bool(dev.converged) and float(dev.error) < 1e-2
    np.testing.assert_allclose(dev.R.numpy(), hosts["got"].R, atol=1e-3)
    np.testing.assert_allclose(dev.t.numpy(), hosts["got"].t, atol=1e-3)
    for f in ("outer_iters", "evals", "inner_iters", "icp_runs", "opt_comp",
              "converged"):
        assert int(getattr(dev, f)) == int(getattr(want, f)), f
    for f in ("error", "R", "t", "gap"):
        np.testing.assert_allclose(getattr(dev, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
