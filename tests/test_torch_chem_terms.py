"""The fork's chem regularisers in the port vs the JAX package: the c-FPFH
descriptor term (cfpfh 1, 2, 3) and the neighbour-mismatch term, on the
same seeded numpy inputs (clouds of at most 52 points, S = 12, descriptors
from goicp_tpu_torch/bench/options.py::seeded_descriptors).

  * the two host helpers the port lacked (adaptive_neighbor_counts,
    string_to_index);
  * preparation with descriptors, the corner values and the lattice bounds
    of both terms, and where those bounds hold;
  * icp_chem_terms, score_transform and refine_transform;
  * register_device and the host engine;
  * the fused stream's row-by-row inner step and the compacting batch
    (K3/K4 carry only the incompatibility count, so both run the terms
    row by row); the packed stream refuses the terms;
  * one bench pair per error option held to its checked-in row
    (goicp_tpu_torch/bench/option_rows.jsonl, the JAX package's
    register_device on XLA:CPU).

Tolerances: descriptor tables, corner values, bounds and scores rtol 1e-6
(the same float32 terms summed in another order); registrations and
streams error within 1e-5, search counters equal; option rows error
within 1e-5, counters equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goicp_tpu.bounds import error as jerr
from goicp_tpu.bounds import evaluate as jev
from goicp_tpu.chem import neighbors as jnbrs
from goicp_tpu.chem import properties as jprops
from goicp_tpu.config import GoICPConfig as JConfig
from goicp_tpu.icp.icp import nn_correspondences as jnn
from goicp_tpu.pipeline import prepare as jprep
from goicp_tpu.search import outer as jouter
from goicp_tpu.search import packed_stream as jpacked
from goicp_tpu.search.device_engine import register_device as jregister
from goicp_tpu.search.fused_stream import register_fused_stream as jstream
from goicp_tpu_torch.bench import options
from goicp_tpu_torch.bounds import error as terr
from goicp_tpu_torch.bounds import evaluate as tev
from goicp_tpu_torch.chem import neighbors as tnbrs
from goicp_tpu_torch.chem import properties as tprops
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.geom.rotation import rodrigues_np
from goicp_tpu_torch.icp.icp import nn_correspondences
from goicp_tpu_torch.pipeline import prepare as tprep
from goicp_tpu_torch.search import outer as touter
from goicp_tpu_torch.search import packed_stream as tpacked
from goicp_tpu_torch.search.chunked import register_device_batch_compact
from goicp_tpu_torch.search.device_engine import register_device
from goicp_tpu_torch.search.fused_stream import register_fused_stream

torch.set_num_threads(1)

CLOSE = dict(rtol=1e-6, atol=1e-6)
TERMS = {"fpfh": dict(cfpfh=1, regularizationFPFH=0.001),
         "nbr": dict(regularizationNeighbors=0.001)}
_SMALL = dict(MSEThresh=0.01, regularization=0.0005, ponderation=1,
              distTransSize=12, rot_batch=1, trans_capacity=16, trans_pop=2,
              inner_max_iters=60, device_rot_capacity=256,
              max_outer_steps=300, icp_seeds=2, icp_max_iter=60)
_COUNTERS = ("outer_iters", "evals", "inner_iters", "icp_runs", "opt_comp",
             "converged")


def _cfgs(**over):
    kw = dict(_SMALL, **over)
    return JConfig(**kw), GoICPConfig(**kw)


def _clouds(seed, n=40, m=44):
    """A planted pair (data a rigid copy of a subset of the model,
    properties carried along) with its seeded descriptors."""
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.7, 0.7, size=(m, 3))
    R = rodrigues_np(rng.uniform(-2.0, 2.0, 3))
    sel = rng.permutation(m)[:n]
    data = (model[sel] - rng.uniform(-0.1, 0.1, 3)) @ R
    mp = rng.integers(0, 9, m).astype(np.int32)
    dp = mp[sel].copy()
    return (data, model, dp, mp) + options.seeded_descriptors(dp, mp, seed)


def _both(raw, jcfg, cfg, dims=None):
    """The pair prepared by each package (count-dynamic in one bucket when
    dims are given)."""
    if dims is None:
        return (jprep.prepare_pair(*raw[:4], jcfg, *raw[4:]),
                tprep.prepare_pair(*raw[:4], cfg, *raw[4:], device="cpu"))
    return (jprep.make_count_dynamic(
                jprep.prepare_pair(*raw[:4], jcfg, *raw[4:], **dims)),
            tprep.make_count_dynamic(
                tprep.prepare_pair(*raw[:4], cfg, *raw[4:], device="cpu",
                                   **dims)))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_adaptive_neighbor_counts_matches_jax():
    rng = np.random.default_rng(0)
    for n, scale in ((40, 0.7), (64, 0.4), (12, 2.0)):
        pts = rng.uniform(-scale, scale, (n, 3))
        got = tnbrs.adaptive_neighbor_counts(pts)
        want = jnbrs.adaptive_neighbor_counts(pts)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        np.testing.assert_array_equal(tnbrs.neighbor_weights(pts),
                                      jnbrs.neighbor_weights(pts))


def test_string_to_index_matches_jax():
    for name in jprops.PROP_NAMES + ["CB", "", "og"]:
        assert tprops.string_to_index(name) == jprops.string_to_index(name)
    assert tprops.string_to_index("CB") == tprops.string_to_index("OG") == 0


@pytest.mark.parametrize("cfpfh", [1, 2, 3])
def test_prepare_with_descriptors_matches_jax(cfpfh):
    """The selected bins (io/cfpfh.py::select_bins) and the per-point /
    per-voxel descriptor tables of both packages."""
    raw = _clouds(3)
    jp, tp = _both(raw, *_cfgs(cfpfh=cfpfh, regularizationFPFH=0.001))
    assert tp.data_fpfh.shape[1] == {1: 41, 2: 33, 3: 8}[cfpfh]
    for f in ("data_fpfh", "model_fpfh", "fpfh_table", "fpfh_voxel"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), **CLOSE,
                                   err_msg=f)


@pytest.mark.parametrize("term", list(TERMS))
def test_chem_corner_bounds(term):
    """A parent's 27 lattice corners: corner values and the per-child
    bounds (reg * max^2 / reg * min^2 over the child's 8 corners) equal
    JAX's, and at each of a child's 8 corners the chem error lies within
    them, the upper one attained.  (Between its corners a child's term is
    not bounded by them in either package: the nearest occupied cell
    changes inside the cube, and the reference's bound is this corner
    rule; ROADMAP Queue 3.)"""
    jcfg, cfg = _cfgs(**TERMS[term])
    raw = _clouds(5)
    jp, tp = _both(raw, jcfg, cfg)
    reg = cfg.regularizationFPFH if term == "fpfh" \
        else cfg.regularizationNeighbors
    rng = np.random.default_rng(7)
    lattice = np.array([[a, b, c] for c in range(3) for b in range(3)
                        for a in range(3)], np.float32)
    for w in (0.5, 0.125):
        pts = np.stack([raw[0] @ rodrigues_np(rng.uniform(-2, 2, 3)).T
                        for _ in range(2)]).astype(np.float32)
        corners = (rng.uniform(-0.5, 0.5 - w, (2, 1, 3))
                   + lattice * (w / 2)).astype(np.float32)
        want = jev.chem_corner_values(jp, jcfg, jnp.asarray(pts),
                                      jnp.asarray(corners))
        got = tev.chem_corner_values(tp, cfg, _t(pts), _t(corners))
        assert sorted(got) == sorted(want) == sorted(["incomp", term])
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **CLOSE, err_msg=k)
        jb = jev.chem_bounds_from_lattice(
            jcfg, {k: v[:, None, :] for k, v in want.items()})
        tb = tev.chem_bounds_from_lattice(
            cfg, {k: v[:, None, :] for k, v in got.items()})
        for g, j in zip(tb[:2], jb[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), **CLOSE)
        regs = {"incomp": cfg.regularization, term: reg}
        ub_add, lb_add, ub_terms = (x[:, 0] if torch.is_tensor(x) else
                                    {k: v[:, 0] for k, v in x.items()}
                                    for x in tb)
        for j in range(8):
            at = {k: v[:, tev._CHILD_CORNER_TO_LATTICE[j]]
                  for k, v in got.items()}                  # (L, 8 corners)
            total = sum(regs[k] * v * v for k, v in at.items())
            assert torch.all(total >= lb_add[:, j:j + 1] - 1e-5)
            assert torch.all(total <= ub_add[:, j:j + 1] + 1e-5)
            np.testing.assert_allclose(
                ub_terms[term][:, j].numpy(),
                (reg * torch.amax(at[term], dim=-1) ** 2).numpy(), **CLOSE)


@pytest.mark.parametrize("over", [
    dict(cfpfh=1, regularizationFPFH=0.001),
    dict(cfpfh=2, regularizationFPFH=0.001),
    dict(cfpfh=3, regularizationFPFH=0.001),
    dict(regularizationNeighbors=0.001),
], ids=["fpfh1", "fpfh2", "fpfh3", "nbr"])
def test_icp_chem_terms_score_and_refine_match_jax(over):
    jcfg, cfg = _cfgs(**over)
    raw = _clouds(9)
    jp, tp = _both(raw, jcfg, cfg)
    R = rodrigues_np(np.array([0.3, -0.2, 0.1]))
    t = np.array([0.02, -0.01, 0.03])
    jR, jt, tR, tt = jnp.asarray(R, jnp.float32), \
        jnp.asarray(t, jnp.float32), _t(R), _t(t)
    jidx, _ = jnn(jp.data @ jR.T + jt, jp.model)
    idx, _ = nn_correspondences(tp.data @ tR.T + tt, tp.model)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    for g, w in zip(terr.icp_chem_terms(tp, cfg, idx),
                    jerr.icp_chem_terms(jp, jcfg, jidx)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CLOSE)
    sc = terr.score_transform(tp, cfg, tR, tt, idx)
    jsc = jerr.score_transform(jp, jcfg, jR, jt, jidx)
    for f in jsc._fields:
        np.testing.assert_allclose(getattr(sc, f).numpy(),
                                   np.asarray(getattr(jsc, f)), **CLOSE,
                                   err_msg=f)
    assert float(sc.fpfh_term if "cfpfh" in over else sc.nbr_term) > 0
    bnb, res, sc, icp_incomp = terr.refine_transform(
        tp, cfg, tR, tt, max_iter=cfg.icp_max_iter)
    jbnb, jres, jsc, jicp = jerr.refine_transform(
        jp, jcfg, jR, jt, max_iter=jcfg.icp_max_iter)
    assert int(bnb) == int(jbnb) and int(icp_incomp) == int(jicp)
    np.testing.assert_array_equal(res.nn_idx[0].numpy(),
                                  np.asarray(jres.nn_idx))
    for f in jsc._fields:
        np.testing.assert_allclose(getattr(sc, f).numpy()[0],
                                   np.asarray(getattr(jsc, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


@pytest.fixture(scope="module")
def fpfh_batch():
    """Three pairs under the fpfh term in one bucket, in both packages,
    and JAX's fused stream over them (width 2: the third pair refills a
    row), whose rows are JAX's register_device trajectories."""
    jcfg, cfg = _cfgs(**TERMS["fpfh"])
    raws = [_clouds(s, n=n, m=m) for s, n, m in
            ((21, 36, 40), (13, 40, 44), (23, 44, 52))]
    dims: dict = {}
    for raw in raws:
        d = jprep.bucket_dims(raw[1], len(raw[0]), len(raw[1]), jcfg)
        dims = {k: max(dims.get(k, 0), v) for k, v in d.items()}
    both = [_both(raw, jcfg, cfg, dims) for raw in raws]
    jpairs = [b[0] for b in both]
    want = jax.device_get(jstream(jpairs, jcfg, width=2, chunk_steps=64))
    return jcfg, cfg, jpairs, [b[1] for b in both], want


def _rows_equal(got, want):
    for f in _COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(np.asarray(got.error), np.asarray(want.error),
                               rtol=1e-5, atol=1e-5)


def test_register_device_and_host_match_jax(fpfh_batch):
    """register_device under the fpfh term equals JAX's on each pair of
    the batch (its row of JAX's fused stream) in every counter and in
    error, R, t, terms and gap; the host engine with both terms on at once
    equals JAX's host engine."""
    _, cfg, _, tpairs, want = fpfh_batch
    for i, tp in enumerate(tpairs):
        got = register_device(tp, cfg)
        assert bool(got.converged)
        for f in _COUNTERS:
            assert int(getattr(got, f)) == int(getattr(want, f)[i]), f
        for f in ("error", "R", "t", "terms", "gap"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)[i]),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
    jcfg, cfg = _cfgs(**TERMS["fpfh"], **TERMS["nbr"])
    jp, tp = _both(_clouds(32), jcfg, cfg)
    host = touter.register(tp, cfg)
    jhost = jouter.register(jp, jcfg)
    assert host.converged and abs(host.error - jhost.error) <= 1e-5
    for k in ("outer_steps", "bound_evals", "icp_runs", "optComp",
              "last_icp"):
        assert getattr(host, k) == getattr(jhost, k), k
    for k in ("geom_error", "incomp_error", "fpfh_error"):
        assert abs(getattr(host, k) - getattr(jhost, k)) <= 1e-5, k
    assert host.fpfh_error > 0 and host.incomp_error > 0


def test_fused_stream_and_batch_row_by_row_match_jax(fpfh_batch):
    """The fused stream (width 2: the third pair refills a row) and the
    compacting batch under the fpfh term, both on the row-by-row inner
    step, equal to JAX's fused stream pair by pair (whose rows are its
    register_device trajectories, as are its batch's) and to the port's
    register_device."""
    _, cfg, _, tpairs, want = fpfh_batch
    assert tev.only_incomp(cfg) is False
    out = register_fused_stream(tpairs, cfg, width=2, chunk_steps=64)
    _rows_equal(out, want)
    batch = register_device_batch_compact(tpairs, cfg, chunk_steps=16)
    _rows_equal(batch, want)
    for i, p in enumerate(tpairs):
        one = register_device(p, cfg)
        for res in (out, batch):
            assert int(res.evals[i]) == int(one.evals)
            assert abs(float(res.error[i]) - float(one.error)) <= 1e-5


@pytest.mark.parametrize("term", list(TERMS))
def test_packed_stream_refuses_the_terms(fpfh_batch, term):
    jcfg, cfg, jpairs, tpairs, _ = fpfh_batch
    jcfg, cfg = (dataclasses.replace(c, **TERMS[term]) for c in (jcfg, cfg))
    assert not jpacked.supports_packed(jpairs[0], jcfg)
    assert not tpacked.supports_packed(tpairs[0], cfg)
    with pytest.raises(ValueError, match="incomp-only"):
        tpacked.register_packed_stream(tpairs, cfg, width=2)


@pytest.mark.parametrize("option", list(options.OPTIONS))
def test_option_row_on_the_cheapest_pair(option):
    """The first pair of each option's list (syn13) through the port's
    register_device on the CPU equals its option_rows.jsonl row: counters
    exact, error and the rescored terms within 1e-5."""
    from goicp_tpu_torch.bench.measure import (_normalized_synthetic,
                                               bench_shape, synthetic_pool)
    name = options.OPTION_PAIRS[option][0]
    row = options.option_rows()[(option, name)]
    cfg = options.option_config(bench_shape(GoICPConfig()), option)
    raw = _normalized_synthetic(next(e for e in synthetic_pool(64, seed=7)
                                     if e[0] == name))
    raw = raw + options.seeded_descriptors(raw[2], raw[3])
    pair = tprep.make_count_dynamic(tprep.prepare_pair(
        *raw[:4], cfg, *raw[4:], bucket=True, device="cpu"))
    r = register_device(pair, cfg)
    got = dict(converged=bool(r.converged), outer=int(r.outer_iters),
               inner=int(r.inner_iters), evals=int(r.evals),
               icp_runs=int(r.icp_runs), compat=int(r.opt_comp))
    assert got == {k: row[k] for k in got}
    assert abs(float(r.error) - row["error"]) <= 1e-5
    np.testing.assert_allclose(r.terms.numpy(), row["terms"], atol=1e-5)
    idx, _ = nn_correspondences(pair.data @ r.R.T + r.t, pair.model)
    sc = terr.score_transform(pair, cfg, r.R, r.t, idx)
    for k, v in row["score"].items():
        assert abs(float(getattr(sc, k)) - v) <= 1e-5, k
