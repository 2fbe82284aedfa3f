"""The inner step at the kernel's interface (goicp_tpu_torch/search/
inner.py::inner_step_plain, the CPU's route and the yardstick of
csrc/inner.cu) against the JAX package's inner body
(goicp_tpu/search/inner.py::_make_inner_body), one iteration at a time:
both take the port's state after each step, so every step is compared on
the same inputs.  Nodes, best_node, done, the corner payload and the
counters must be equal; lbs, opt_err, thr, min_dropped and ub_terms within
1e-5 relative (the bound sums take another order in XLA than in the
port).  Then built NaN/INF lbs through both merge orders, the live groups
and counters of the interface, and the router.  The tests marked `cuda`
hold the kernel (goicp_inner_step) to the plain step bit for bit on the
card; they skip without one."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goicp_tpu.config import GoICPConfig
from goicp_tpu.geom.rotation import rodrigues_np
from goicp_tpu.pipeline import prepare as jprep
from goicp_tpu.search import inner as jinner
from goicp_tpu_torch import config as tconfig
from goicp_tpu_torch.bounds.evaluate import lane_tables, rot_uncertainty
from goicp_tpu_torch.dist.mesh import stack_pairs
from goicp_tpu_torch.pipeline.prepare import pair_from_jax
from goicp_tpu_torch.search import inner as tinner
from tests.test_fused_stream import _pairs

# small torch ops in a loop: intra-op threads only contend with the
# parallel test workers (see test_torch_device_engine.py)
torch.set_num_threads(1)

STEPS = 4
INC = 40.0
ACTIVE = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)


def _cfg(**kw):
    return GoICPConfig(**{"MSEThresh": 0.01, "regularization": 0.0005,
                          "ponderation": 1, "distTransSize": 12,
                          "trans_capacity": 64, "trans_pop": 4,
                          "inner_max_iters": 200, "chem_reuse": 1,
                          "lane_compaction": 1, **kw})


def _port_cfg(cfg):
    return tconfig.GoICPConfig(**{f.name: getattr(cfg, f.name) for f in
                                  dataclasses.fields(tconfig.GoICPConfig)})


def _one_pair(seed, n=40, trim=0.0, dynamic=False, **kw):
    """A pair of <= 64 points in both packages, 8 rotated lanes and their
    rotation widths (test_torch_inner.py's case)."""
    cfg = _cfg(trimFraction=trim, **kw)
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-0.8, 0.8, size=(n + 8, 3))
    R = rodrigues_np(rng.uniform(-1.0, 1.0, 3))
    src = (tgt[:n] - 0.05) @ R.T
    props = rng.integers(0, 9, size=n + 8).astype(np.int32)
    jp = jprep.prepare_pair(src, tgt, props[:n], props, cfg, pad_data_to=64)
    if dynamic:
        jp = jprep.make_count_dynamic(jp)
    rots = np.stack([rodrigues_np(v) for v in rng.uniform(-2, 2, (8, 3))])
    pts = np.einsum("lij,nj->lni", rots, np.asarray(jp.data)
                    ).astype(np.float32)
    widths = rng.uniform(0.2, 1.2, size=(8,)).astype(np.float32)
    return cfg, jp, pts, widths


def _init_lanes(tp, cfg, pts, active):
    """inner_bnb's initial per-lane state (root node, incumbent INC)."""
    return tinner.initial_lanes(tp, cfg, pts, torch.as_tensor(active),
                                torch.tensor(INC))


def _jax_step(jp, cfg, pts, mrd, s, fused):
    """One iteration of the JAX package's body on the port's state."""
    body = jinner._make_inner_body(
        jp, cfg, jnp.asarray(pts.numpy()),
        None if mrd is None else jnp.asarray(mrd.numpy()),
        jnp.float32(cfg.mse_margin) * jp.inlier_f(),
        jnp.asarray(jinner._CHILD_OFFSETS, jnp.float32),
        jnp.asarray(jinner._LATTICE_OFFSETS, jnp.float32),
        jinner._chem_active(cfg), fused)
    js = {k: jnp.asarray(v.numpy()) for k, v in s.items()}
    js.update(it=jnp.int32(0), evals=jnp.int32(0), geom_surv=jnp.int32(0),
              chem_corners=jnp.int32(0))
    return {k: np.asarray(v) for k, v in body(js).items()}


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg=name)


def _compare(got, cnt, want, where):
    for k in ("done", "nodes", "best_node", "cvals"):
        if k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          f"{where}: {k}")
    for k in ("lbs", "opt_err", "thr", "min_dropped", "ub_terms"):
        _close(got[k].numpy(), want[k], f"{where}: {k}")
    for k in ("evals", "geom_surv", "chem_corners"):
        if cnt is not None:
            assert int(cnt[k].sum()) == int(want[k]), (where, k)


def _run_one_pair(cfg, jp, pts_np, widths, fused, unc, steps=STEPS):
    tcfg = _port_cfg(cfg)
    tp = pair_from_jax(jp, "cpu")
    pts = torch.as_tensor(pts_np)
    mrd = rot_uncertainty(torch.as_tensor(widths), tp.norm_data) \
        if (fused or unc) else None
    s = _init_lanes(tp, tcfg, pts, ACTIVE)
    evals = 0
    for i in range(steps):
        want = _jax_step(jp, cfg, pts, mrd, s, fused)
        got, cnt, st = tinner.inner_step_plain(tp, tcfg, s, pts, mrd, fused)
        _compare(got, cnt, want, f"step {i}")
        assert int(cnt["it"]) == 1
        assert int(st.n_active) == int((~got["done"]).sum())
        evals += int(cnt["evals"])
        s = got
    assert evals > 0
    return s


@pytest.mark.parametrize("variant", [
    dict(fused=True),
    dict(fused=True, cfg=dict(chem_reuse=0)),
    dict(fused=True, cfg=dict(regularization=0.0)),
    dict(fused=True, cfg=dict(sorted_merge=1)),
    dict(fused=True, cfg=dict(norm=1)),
    dict(fused=True, trim=0.1, dynamic=True),
    dict(fused=True, trim=0.1),
    dict(fused=False, unc=True),
    dict(fused=False, unc=False),
])
def test_plain_step_matches_jax_body(variant):
    cfg, jp, pts, widths = _one_pair(
        seed=1, trim=variant.get("trim", 0.0),
        dynamic=variant.get("dynamic", False), **variant.get("cfg", {}))
    _run_one_pair(cfg, jp, pts, widths, variant["fused"],
                  variant.get("unc", False))


def _two_pairs(cfg):
    """Two bucketed count-dynamic pairs, their stacked LaneTables with the
    8 lanes interleaved between them, the lanes' points and rotation
    uncertainty."""
    jpairs = _pairs(cfg, n=2, seed=5)
    tcfg = _port_cfg(cfg)
    pairs = [pair_from_jax(p, "cpu") for p in jpairs]
    lane_pair = torch.tensor([0, 1, 1, 0, 1, 0, 0, 1], dtype=torch.int32)
    tables = lane_tables(stack_pairs(pairs), tcfg, lane_pair)
    rng = np.random.default_rng(8)
    rots = np.stack([rodrigues_np(v) for v in rng.uniform(-2, 2, (8, 3))])
    pts = torch.as_tensor(np.stack([
        rots[l] @ np.asarray(jpairs[w].data).T for l, w in
        enumerate(lane_pair.tolist())]).transpose(0, 2, 1).astype(np.float32))
    widths = torch.as_tensor(rng.uniform(0.2, 1.2, 8).astype(np.float32))
    mrd = torch.stack([rot_uncertainty(widths[l:l + 1],
                                       pairs[w].norm_data)[0]
                       for l, w in enumerate(lane_pair.tolist())])
    return tcfg, jpairs, pairs, tables, pts.contiguous(), mrd, lane_pair


def test_two_pairs_interleaved_match_jax_per_pair():
    cfg = _cfg()
    tcfg, jpairs, pairs, tables, pts, mrd, lane_pair = _two_pairs(cfg)
    # each lane's root corner payload from its own pair
    s = _init_lanes(pairs[0], tcfg, pts, ACTIVE)
    sel = torch.nonzero(lane_pair == 1)[:, 0]
    s["cvals"][sel, 0] = tinner.root_corner_values(pairs[1], tcfg, pts[sel])
    for i in range(STEPS):
        got, cnt, _ = tinner.inner_step_plain(tables, tcfg, s, pts, mrd, True)
        total = dict(evals=0, geom_surv=0, chem_corners=0)
        for w in (0, 1):
            sel = torch.nonzero(lane_pair == w)[:, 0]
            want = _jax_step(jpairs[w], cfg, pts[sel], mrd[sel],
                             {k: v[sel] for k, v in s.items()}, True)
            _compare({k: v[sel] for k, v in got.items()}, None, want,
                     f"step {i} pair {w}")
            for k in total:
                total[k] += int(want[k])
        for k in total:
            assert int(cnt[k]) == total[k], (i, k)
        s = got


def _nan_inf_state(cfg, jp, pts_np, widths, merge):
    """A mid-search state with built NaN and INF lbs: the frontier's last
    finite entries of two lanes NaN and INF, a popped parent's lb NaN in a
    third, and one stored corner of a popped parent NaN in a fourth, so
    that children's ub and lb are NaN and adoption takes a NaN.  The
    frontier past the pop stays in the merge's order, as every merge leaves
    it (the kernel's precondition): NaN ranks as +inf under sorted_merge 1,
    after +inf under sorted_merge 0, where the NaN entries are the rows'
    tails."""
    tcfg = dataclasses.replace(_port_cfg(cfg), sorted_merge=merge)
    tp = pair_from_jax(jp, "cpu")
    pts = torch.as_tensor(pts_np)
    mrd = rot_uncertainty(torch.as_tensor(widths), tp.norm_data)
    s = _init_lanes(tp, tcfg, pts, np.ones(8, bool))
    for _ in range(2):
        s, _, _ = tinner.inner_step_plain(tp, tcfg, s, pts, mrd, True)
    lbs = s["lbs"].clone()
    finite = torch.isfinite(lbs).sum(dim=1)
    assert int(finite.min()) > cfg.trans_pop + 2
    if merge:
        lbs[0, int(finite[0]) - 1] = float("nan")
        lbs[1, int(finite[1])] = float("nan")
    else:
        lbs[0, int(finite[0]) - 1:] = float("nan")
        lbs[1, -1] = float("nan")
    lbs[0, int(finite[0]) - 2] = float("inf")
    lbs[1, int(finite[1]) - 1] = float("inf")
    rest = lbs[:, cfg.trans_pop:]
    nan = torch.isnan(rest)
    key = torch.where(nan, float("inf"), rest)
    assert bool((key[:, 1:] >= key[:, :-1]).all())
    assert merge or bool((nan[:, :-1] <= nan[:, 1:]).all())
    lbs[3, 1] = float("nan")
    cv = s["cvals"].clone()
    cv[4, 0, 3] = float("nan")
    return tcfg, tp, pts, mrd, dict(s, lbs=lbs, cvals=cv)


@pytest.mark.parametrize("merge", [0, 1])
def test_nan_and_inf_lbs_through_both_merges(merge):
    cfg, jp, pts_np, widths = _one_pair(seed=1)
    jcfg = dataclasses.replace(cfg, sorted_merge=merge)
    tcfg, tp, pts, mrd, s = _nan_inf_state(cfg, jp, pts_np, widths, merge)
    want = _jax_step(jp, jcfg, pts, mrd, s, True)
    got, cnt, _ = tinner.inner_step_plain(tp, tcfg, s, pts, mrd, True)
    _compare(got, cnt, want, f"sorted_merge={merge}")
    assert np.isnan(got["opt_err"][4].item())        # adopted a NaN child
    assert torch.isnan(got["lbs"]).any()


def test_live_groups_and_counters():
    """Two groups of four lanes: the group not live keeps its state whole
    and its counters; the live one steps as the body alone does, and its
    counters advance by its lanes' counts."""
    cfg, jp, pts_np, widths = _one_pair(seed=1)
    tcfg = _port_cfg(cfg)
    tp = pair_from_jax(jp, "cpu")
    pts = torch.as_tensor(pts_np)
    mrd = rot_uncertainty(torch.as_tensor(widths), tp.norm_data)
    s = _init_lanes(tp, tcfg, pts, ACTIVE)
    counters = {k: torch.tensor([5, 7], dtype=torch.int32)
                for k in tinner._COUNTERS}
    live = torch.tensor([False, True])
    got, cnt, st = tinner.inner_step_plain(tp, tcfg, s, pts, mrd, True,
                                           live=live, groups=2,
                                           counters=counters)
    alone, _, st1 = tinner.inner_step_plain(tp, tcfg, s, pts, mrd, True)
    for k, v in got.items():
        assert torch.equal(v[:4], s[k][:4]), k
        assert torch.equal(v[4:], alone[k][4:]), k
    assert cnt["it"].tolist() == [5, 8]
    assert cnt["evals"].tolist() == [5, 7 + int(st1.evals[4:].sum())]
    assert cnt["geom_surv"].tolist() == [
        5, 7 + int(st1.geom_surv[4:].sum())]
    assert cnt["chem_corners"].tolist() == [
        5, 7 + 4 * st1.corners_per_lane]
    assert int(st.evals[:4].sum()) == 0


def test_router_picks_the_kernel_inside_its_envelope(monkeypatch):
    """kernel_carries and inner_iteration on the predicate alone (no card
    needed): the bench's configuration, with or without its chem term and
    at any pop and capacity, goes to inner_step (one launch on a card, the
    plain step on the CPU); two-phase chem, c-FPFH and neighbour terms go
    to the torch body."""
    from goicp_tpu_torch.bench.measure import bench_shape
    bench = bench_shape(tconfig.GoICPConfig())
    called = []
    monkeypatch.setattr(tinner, "inner_step",
                        lambda *a: called.append("kernel"))
    monkeypatch.setattr(tinner, "inner_step_plain",
                        lambda *a: called.append("body"))
    for over, route in ((dict(), "kernel"), (dict(regularization=0.0),
                                             "kernel"),
                        (dict(trans_pop=80, trans_capacity=5000), "kernel"),
                        (dict(chem_survivors=8), "body"),
                        (dict(cfpfh=1, regularizationFPFH=0.001), "body"),
                        (dict(regularizationNeighbors=0.001), "body")):
        c = dataclasses.replace(bench, **over)
        assert tinner.kernel_carries(c) == (route == "kernel"), over
        tinner.inner_iteration(None, c, {}, None, None, True)
        assert called.pop() == route, over


def test_step_buffers_never_hand_out_an_input():
    """A run's StepBuffers: a step whose inputs lie in one output set gets
    the other; one whose inputs lie in both (the nodes of one step beside
    the lbs of the next) gets a new set, whichever field it is."""
    L, C = 8, 16
    f32 = torch.float32
    lanes = dict(nodes=torch.zeros((L, C, 4)), lbs=torch.zeros((L, C)),
                 opt_err=torch.zeros(L), thr=torch.zeros(L),
                 best_node=torch.zeros((L, 4)), ub_terms=torch.zeros((L, 3)),
                 min_dropped=torch.zeros(L),
                 done=torch.zeros(L, dtype=torch.bool))
    pts = torch.zeros((L, 5, 3), dtype=f32)
    bufs = tinner.StepBuffers()

    def step(fields, counters=()):
        out, cnt, _, _ = tinner._step_outputs(
            fields, list(fields.values()) + list(counters), L, C, False, 1,
            10, pts, bufs)
        return out, cnt

    def mem(out):
        return {v.untyped_storage().data_ptr() for v in out.values()}

    a, _ = step(lanes)
    b, cnt = step(a)
    assert mem(a).isdisjoint(mem(b))
    c, _ = step(b, cnt.values())
    assert mem(c) == mem(a)
    for k in lanes:
        mixed = dict(c, **{k: b[k]})
        d, _ = step(mixed)
        assert mem(d).isdisjoint(mem(mixed)), k


# ---------------------------------------------------------------------------
# the kernel on the card (skips without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(got, want):
    g, w = got.cpu(), want.cpu()
    if g.dtype == torch.float32:
        return torch.equal(g.view(torch.int32), w.view(torch.int32)) or (
            torch.equal(torch.isnan(g), torch.isnan(w))
            and torch.equal(torch.where(torch.isnan(g), 0, g),
                            torch.where(torch.isnan(w), 0, w)))
    return torch.equal(g, w)


def _kernel_vs_plain(tp, tcfg, s, pts, mrd, fused, **kw):
    got = tinner.inner_step(tp, tcfg, s, pts, mrd, fused, **kw)
    want = tinner.inner_step_plain(tp, tcfg, s, pts, mrd, fused, **kw)
    for k in want[0]:
        assert _same(got[0][k], want[0][k]), k
    for k in want[1]:
        assert _same(got[1][k], want[1][k]), k
    assert int(got[2].n_active) == int(want[2].n_active)
    return got[0]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [
    dict(fused=True), dict(fused=True, cfg=dict(chem_reuse=0)),
    dict(fused=True, cfg=dict(sorted_merge=1)),
    dict(fused=True, trim=0.1, dynamic=True), dict(fused=True, trim=0.1),
    dict(fused=False, unc=True), dict(fused=False, unc=False),
    dict(fused=True, cfg=dict(trans_pop=80, trans_capacity=5000)),
])
def test_kernel_equals_plain_step(card, variant):
    cfg, jp, pts_np, widths = _one_pair(
        seed=1, trim=variant.get("trim", 0.0),
        dynamic=variant.get("dynamic", False), **variant.get("cfg", {}))
    tcfg = _port_cfg(cfg)
    tp = pair_from_jax(jp, card)
    pts = torch.as_tensor(pts_np, device=card)
    fused, unc = variant["fused"], variant.get("unc", False)
    mrd = rot_uncertainty(torch.as_tensor(widths, device=card),
                          tp.norm_data) if (fused or unc) else None
    s = {k: v.to(card) for k, v in _init_lanes(
        pair_from_jax(jp, "cpu"), tcfg, pts.cpu(), ACTIVE).items()}
    for _ in range(STEPS):
        s = _kernel_vs_plain(tp, tcfg, s, pts, mrd, fused)


@pytest.mark.cuda
@pytest.mark.parametrize("merge", [0, 1])
def test_kernel_nan_and_inf_lbs(card, merge):
    cfg, jp, pts_np, widths = _one_pair(seed=1)
    tcfg, _, pts, mrd, s = _nan_inf_state(cfg, jp, pts_np, widths, merge)
    _kernel_vs_plain(pair_from_jax(jp, card), tcfg,
                     {k: v.to(card) for k, v in s.items()}, pts.to(card),
                     mrd.to(card), True,
                     live=torch.tensor([True, False], device=card), groups=2)
