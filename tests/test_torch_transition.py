"""The outer-step transition at the kernel's interface (goicp_tpu_torch/
search/transition.py: harvest_plain and advance_plain, the CPU's route and
the yardstick of csrc/transition.cu) against the JAX package on the same
state.

The streams' half: a window of three pairs run by the JAX package's own
fused_init + fused_run_chunk, carried across with stream_state_from_jax,
then edited the same way on both sides into each case below; JAX's
_harvest and _advance vmapped over the window against harvest_plain and
advance_plain("both") on the rows that transition, both fed the same
refine block.  register_device's half: the pop and the adoption around
one inner search, against the JAX package's device_engine._make_body run
with an inner search that returns the port's result (so that the head and
the tail are compared on the same inner result).

Cases: corner reuse on and off; improved by the BnB candidate, by the
ICP, by neither; a converging pop; a frontier that overflows its capacity
(min_dropped); a NaN incumbent; built INF lbs.  Nodes, order, flags and
counters exact; R within 1e-6 absolute (XLA's sin/cos against
sincos32), so the rotated points within 1e-6 times each point's L1 norm
(the padding points lie far out) and mrd within 1e-6 relative; lbs and
errors within 1e-5 relative (an ICP's R, t and terms within 1e-6 absolute
besides: XLA's jitted Kabsch against the port's).  The frontier's rest is checked sorted
wherever the merge reads it: the kernel's merge path requires it (every
engine keeps it so; the one case built out of order holds only the torch
code to JAX).  The
tests marked `cuda` hold the kernels to the plain versions bit for bit on
the card; they skip without one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goicp_tpu.dist.mesh import stack_pairs as jstack_pairs
from goicp_tpu.search import device_engine as jeng
from goicp_tpu.search import fused_stream as jfs
from goicp_tpu.search.inner import InnerResult as JInnerResult
from goicp_tpu_torch.dist.mesh import stack_pairs
from goicp_tpu_torch.search import device_engine as teng
from goicp_tpu_torch.search import fused_stream as tfs
from goicp_tpu_torch.search import inner as tinner
from goicp_tpu_torch.search import transition as tr
from tests.test_fused_stream import _pairs, _small_cfg
from tests.test_torch_fused_stream import _port_cfg, _port_pairs

# small torch ops in a loop: intra-op threads only contend with the
# parallel test workers (see test_torch_device_engine.py)
torch.set_num_threads(1)

STEPS = 6            # JAX global iterations before the compared transition
CR = 64              # device_rot_capacity
INF = np.float32(np.inf)


def _jcfg(reuse: int):
    return _small_cfg(chem_reuse=reuse, device_rot_capacity=CR)


@pytest.fixture(scope="module")
def window():
    """Three pairs (<= 60 points) and the JAX window state after STEPS
    global iterations, with corner reuse (its cvals dropped for the case
    without)."""
    jcfg = _jcfg(1)
    jpairs = _pairs(jcfg, n=3)
    jpb = jstack_pairs(jpairs)
    js = jfs.fused_run_chunk(jpb, jcfg, jfs._jit_init(jcfg)(jpb),
                             np.int32(STEPS))
    state = jax.tree_util.tree_map(np.array, jax.device_get(js))
    return dict(jpairs=jpairs, jpb=jpb, state=state,
                tpb=stack_pairs(_port_pairs(jpairs)))


def _close(got, want, what, rel=1e-5, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rel, atol=atol,
                               equal_nan=True, err_msg=what)


def _equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _close_rotated(got, want, what):
    """Rotated points whose R agree within 1e-6 absolute: each coordinate
    within 1e-6 times the point's L1 norm, plus an ulp of the value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = 1e-6 * (1.0 + np.abs(want).sum(-1, keepdims=True)) \
        + np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, np.argwhere(bad)[:3])


def _sorted_rest(lbs):
    """The frontier keeps ascending lbs (inf last, no NaN)."""
    lbs = np.asarray(lbs)
    assert not np.isnan(lbs).any()
    assert (lbs[..., 1:] >= lbs[..., :-1]).all()


# ---------------------------------------------------------------------------
# the streams' half
# ---------------------------------------------------------------------------

def _edit(state: dict, case: str, h_jax: dict) -> dict:
    """A copy of the window state edited into `case` (row 0 the edited
    row; rows 1, 2 as run); h_jax: JAX's harvest of the state as run."""
    s = jax.tree_util.tree_map(np.array, state)
    ist = s["inner"]
    if case in ("bnb", "icp"):
        # the candidate beats the incumbent
        assert np.isfinite(h_jax["cand_ub"][0])
        s["opt_err"][0] = np.float32(h_jax["cand_ub"][0] * 2 + 1)
    elif case == "converging":
        # every child and every frontier entry pruned by the incumbent
        s["opt_err"][0] = np.float32(1e-9)
        ist["opt_err"][0] = np.maximum(ist["opt_err"][0], np.float32(1.0))
    elif case == "overflow":
        # a full frontier below the incumbent: merging the children drops
        # finite lbs
        rng = np.random.default_rng(3)
        lbs = h_jax["lb_safe"]
        lo = float(np.nanmin(np.where(np.isfinite(lbs), lbs, np.nan)))
        s["fr_lbs"][0] = np.sort(rng.uniform(0.5 * lo, 1.5 * lo, CR)
                                 ).astype(np.float32)
        s["fr_nodes"][0] = rng.uniform(-3, 3, (CR, 4)).astype(np.float32)
        s["fr_nodes"][0, :, 3] = np.float32(0.7853982)
        s["opt_err"][0] = np.float32(1e3)
    elif case == "nan_incumbent":
        lane = int(np.argmax(s["active"][0]))
        ist["opt_err"][0, lane] = np.float32(np.nan)
    elif case == "inf_lbs":
        ist["lbs"][0, :, 1] = INF
        ist["thr"][0, 1] = INF
        ist["min_dropped"][0, 2] = INF
        s["fr_lbs"][0, 1:] = INF
    elif case == "out_of_order":
        # no engine leaves such a frontier, and the kernel's merge path
        # requires a sorted one: only the torch code is held to JAX here
        # (both sorts place ties by index and NaN last)
        rng = np.random.default_rng(4)
        lbs = rng.uniform(0.0, 50.0, CR).astype(np.float32)
        lbs[CR // 2:CR // 2 + 4] = lbs[1]
        lbs[3] = np.float32(np.nan)
        s["fr_lbs"][0] = lbs
        s["fr_nodes"][0] = rng.uniform(-3, 3, (CR, 4)).astype(np.float32)
        s["opt_err"][0] = np.float32(1e3)
    return s


def _jax_harvest(jpb, jcfg, s: dict) -> dict:
    """JAX's harvest of every row of the window, as numpy."""
    js = jax.tree_util.tree_map(jnp.asarray, s)
    h = jax.vmap(jfs._harvest, in_axes=(0, None, 0))(jpb, jcfg, js)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(h))


def _jax_transition(jpb, jcfg, s: dict, rows, r_np: dict):
    """JAX's harvest and advance (vmapped over the window) of the rows
    `rows`, with the refine block r_np (W rows, do_icp marks the rows that
    refined)."""
    W = s["opt_err"].shape[0]
    mask = jnp.asarray(np.isin(np.arange(W), rows))
    js = jax.tree_util.tree_map(jnp.asarray, s)
    h = jax.vmap(jfs._harvest, in_axes=(0, None, 0))(jpb, jcfg, js)
    bnb = mask & ~(h["cand_ub"] >= js["opt_err"])
    incumbent = jnp.minimum(js["opt_err"], h["cand_ub"])
    r = {k: jnp.asarray(v) for k, v in r_np.items() if k != "do_icp"}
    icp_improved = jnp.asarray(r_np["do_icp"]) & ~(r["icp_err"] >= incumbent)
    new = jax.vmap(jfs._advance, in_axes=(0, None, 0, 0, 0, 0, 0, 0))(
        jpb, jcfg, js, h, r, mask, bnb, icp_improved)
    return (jax.tree_util.tree_map(np.asarray, jax.device_get(h)),
            jax.tree_util.tree_map(np.asarray, jax.device_get(new)))


def _refine_np(W: int, h_jax: dict, s: dict, how: str) -> dict:
    """A refine block for every row: `how` for row 0 ('none': no ICP;
    'bnb': an ICP that does not beat the candidate; 'icp': one that does),
    none for the others."""
    r = dict(icp_R=np.tile(np.eye(3, dtype=np.float32), (W, 1, 1)),
             icp_t=np.zeros((W, 3), np.float32),
             icp_err=np.full((W,), INF, np.float32),
             icp_terms=np.zeros((W, 3), np.float32),
             icp_incomp=np.zeros((W,), np.int32),
             bnb_comp=np.zeros((W,), np.int32),
             do_icp=np.zeros((W,), bool))
    if how != "none":
        inc = min(float(s["opt_err"][0]), float(h_jax["cand_ub"][0]))
        r["do_icp"][0] = True
        r["icp_err"][0] = np.float32(inc * (0.5 if how == "icp" else 2.0))
        r["icp_R"][0] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]],
                                 np.float32)
        r["icp_t"][0] = np.float32([0.01, -0.02, 0.03])
        r["icp_terms"][0] = np.float32([1.5, 0.25, 0.0])
        r["icp_incomp"][0] = 7
        r["bnb_comp"][0] = 5
    return r


STREAM_CASES = [("as_run", "none", 1), ("as_run", "none", 0),
                ("bnb", "bnb", 1), ("icp", "icp", 1), ("icp", "icp", 0),
                ("bnb", "none", 0),
                ("converging", "none", 1), ("overflow", "none", 1),
                ("nan_incumbent", "none", 1), ("inf_lbs", "none", 0),
                ("out_of_order", "none", 1)]


@pytest.mark.parametrize("case,how,reuse", STREAM_CASES)
def test_stream_transition_matches_jax(window, case, how, reuse):
    jcfg = _jcfg(reuse)
    cfg = _port_cfg(jcfg)
    state = window["state"]
    if not reuse:
        state = dict(state, inner={k: v for k, v in state["inner"].items()
                                   if k != "cvals"})
    W = state["opt_err"].shape[0]
    s = _edit(state, case, _jax_harvest(window["jpb"], jcfg, state))
    rows = [w for w in range(W) if not s["converged"][w]]
    assert 0 in rows
    r_np = _refine_np(W, _jax_harvest(window["jpb"], jcfg, s), s, how)
    h_j, new_j = _jax_transition(window["jpb"], jcfg, s, rows, r_np)

    ts = tfs.stream_state_from_jax(s, "cpu")
    for w in rows:
        if case != "out_of_order":
            _sorted_rest(ts["fr_lbs"][w])
    h = tr.harvest_plain(ts, rows)
    for k in ("lb_safe", "ubs", "cand_ub", "cand_terms"):
        _close(h[k], h_j[k][rows], f"harvest {k}")
    _close(h["cand_R"], h_j["cand_R"][rows], "harvest cand_R", atol=1e-6)
    _equal(h["cand_t"], h_j["cand_t"][rows], "harvest cand_t")
    improved = ~(h_j["cand_ub"] >= s["opt_err"])
    _equal(h["improved"], improved[rows], "improved")
    if case in ("bnb", "icp"):
        assert bool(h["improved"][0])
    if case == "nan_incumbent":
        assert np.isnan(float(h["cand_ub"][0]))

    r = tr.refine_rows(len(rows), "cpu")
    for j, w in enumerate(rows):
        if r_np["do_icp"][w]:
            tr.set_refine(r, j, {k: torch.as_tensor(v[w])
                                 for k, v in r_np.items() if k != "do_icp"})
    new = tr.advance_plain("both", cfg, window["tpb"], ts, rows, h=h, r=r)
    for j, w in enumerate(rows):
        _row_matches(new, j, new_j, w, reuse)
    if case == "converging":
        assert bool(new["converged"][0]) and not new["active"][0].any()
    if case == "overflow":
        assert np.isfinite(float(new["min_dropped"][0]))
    if case == "nan_incumbent":
        assert bool(new["converged"][0]) and np.isnan(float(new["opt_err"][0]))
    if how == "icp":
        assert bool(new["last_icp"][0])
        _equal(new["opt_R"][0], r_np["icp_R"][0], "ICP's R adopted")
    if case == "out_of_order":
        assert np.isfinite(float(new["min_dropped"][0]))
    else:
        _sorted_rest(new["fr_lbs"])


def _row_matches(new: dict, j: int, want: dict, w: int, reuse: int):
    """Port row j of a transition == JAX row w, at the tolerances of the
    module docstring."""
    for k in ("fr_nodes", "child_nodes", "widths", "active", "comp",
              "last_icp", "it", "evals", "inner_it", "icp_runs",
              "geom_surv", "chem_corners", "converged"):
        _equal(new[k][j], want[k][w], k)
    for k in ("fr_lbs", "opt_err", "opt_t", "terms", "min_dropped",
              "final_lb"):
        _close(new[k][j], want[k][w], k)
    _close(new["opt_R"][j], want["opt_R"][w], "opt_R", atol=1e-6)
    _close(new["R_lanes"][j], want["R_lanes"][w], "R_lanes", rel=0.0,
           atol=1e-6)
    _close_rotated(new["pts_rot"][j], want["pts_rot"][w], "pts_rot")
    _close(new["mrd"][j], want["mrd"][w], "mrd", rel=1e-6, atol=1e-6)
    ist, jst = new["inner"], want["inner"]
    for k in ("nodes", "done", "best_node", "ub_terms", "it", "evals",
              "geom_surv", "chem_corners") + (("cvals",) if reuse else ()):
        _equal(ist[k][j], jst[k][w], f"inner {k}")
    for k in ("lbs", "opt_err", "thr", "min_dropped"):
        _close(ist[k][j], jst[k][w], f"inner {k}")


# ---------------------------------------------------------------------------
# register_device's half: the pop and the adoption around an inner search
# ---------------------------------------------------------------------------

def _device_state(jp, jcfg, case: str) -> dict:
    """The JAX package's device_init, as numpy, edited into `case`."""
    s = jax.tree_util.tree_map(np.array, jax.device_get(
        jax.jit(jeng.device_init, static_argnames=("cfg",))(jp, jcfg)))
    if case == "converging":
        s["fr_lbs"][:] = INF
    elif case == "nan_incumbent":
        s["opt_err"] = np.float32(np.nan)
    elif case == "overflow":
        # a full frontier of the root's neighbours, sorted, under the
        # incumbent: the children's merge drops finite lbs
        rng = np.random.default_rng(5)
        s["fr_lbs"] = np.sort(rng.uniform(0.0, 1e-3, CR)).astype(np.float32)
        nodes = rng.uniform(-3, 0, (CR, 4)).astype(np.float32)
        nodes[:, 3] = np.float32(3.1416)
        s["fr_nodes"] = nodes
        s["opt_err"] = np.float32(1e3)
    elif case == "inf_lbs":
        s["fr_lbs"][2:] = INF
    return s


def _to_port_state(s: dict) -> dict:
    return {k: (int(v) if k == "it" else torch.as_tensor(np.array(v)))
            for k, v in s.items()}


@pytest.mark.parametrize("case,reuse", [("first", 1), ("first", 0),
                                        ("converging", 1),
                                        ("nan_incumbent", 1),
                                        ("overflow", 1), ("inf_lbs", 0)])
def test_device_step_head_and_tail_match_jax(window, monkeypatch, case,
                                             reuse):
    jcfg = _jcfg(reuse)
    cfg = _port_cfg(jcfg)
    jp = window["jpairs"][1]
    tp = _port_pairs([jp])[0]
    js = _device_state(jp, jcfg, case)
    ts = _to_port_state(js)
    _sorted_rest(ts["fr_lbs"][cfg.rot_batch:])

    # the head: the port's pop, then the port's inner search from its lanes
    p = teng._pop(tp, cfg, ts)
    raw = tinner.inner_bnb(tp, cfg, p["pts"], p["widths"], p["active"],
                           ts["opt_err"], False, True, lanes0=p["lanes"],
                           mrd=p["mrd"], raw=True)
    res = raw[0]
    lb_safe = tr.harvest_plain(teng._harvest_src(p, ts["opt_err"], res),
                               [0], lb=teng._lb_lanes(raw[1]))["lb_safe"][0]
    head = {}

    def jinner(pair, pts, widths, active, inc):
        head.update(pts=np.asarray(pts), widths=np.asarray(widths),
                    active=np.asarray(active))
        return JInnerResult(
            best_err=jnp.asarray(res.best_err.numpy()),
            best_node=jnp.asarray(res.best_node.numpy()),
            lb_safe=jnp.asarray(lb_safe.numpy()),
            ub_terms=jnp.asarray(res.ub_terms.numpy()),
            iters=jnp.int32(res.iters), evals=jnp.int32(int(res.evals)),
            geom_surv=jnp.int32(int(res.geom_surv)),
            chem_corners=jnp.int32(res.chem_corners))
    want = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jeng._make_body(jp, jcfg, jinner)(
            jax.tree_util.tree_map(jnp.asarray, js))))
    _close_rotated(p["pts"], head["pts"], "pts")
    _equal(p["widths"], head["widths"], "widths")
    _equal(p["active"], head["active"], "active")
    if case in ("converging", "nan_incumbent"):
        assert bool(p["converged"]) and not p["active"].any()
    # the pop's fresh lanes are inner.initial_lanes'
    init = tinner.initial_lanes(tp, cfg, p["pts"], p["active"],
                                ts["opt_err"])
    assert set(init) == set(p["lanes"])
    for k, v in init.items():
        _equal(p["lanes"][k], v, f"lanes {k}")

    # the tail: the port's whole outer step on the same inner result
    monkeypatch.setattr(teng, "inner_bnb", lambda *a, **kw: raw)
    got, converged = teng._make_body(tp, cfg)(ts)
    assert converged == bool(p["converged"])
    for k in ("fr_nodes", "comp", "last_icp", "evals", "inner_it",
              "icp_runs", "geom_surv", "chem_corners", "converged"):
        _equal(got[k], want[k], k)
    for k in ("fr_lbs", "opt_err", "min_dropped", "final_lb"):
        _close(got[k], want[k], k)
    # the ICP's result: XLA's jitted Kabsch against the port's
    for k in ("opt_R", "opt_t", "terms"):
        _close(got[k], want[k], k, atol=1e-6)
    assert got["it"] == int(want["it"])
    if case == "overflow":
        assert np.isfinite(float(got["min_dropped"]))
    _sorted_rest(got["fr_lbs"])


def test_batch_pop_outputs_carry_every_chem_term(window):
    """The batch engine's pop writes into B-row outputs (transition.
    outputs): with two chem terms under corner reuse (the neighbour term
    beside the count, which the kernels do not carry) each lane's corner
    payload is 16 wide, and the rows written equal the pop's own
    outputs."""
    cfg = _port_cfg(_small_cfg(chem_reuse=1, regularizationNeighbors=1e-3))
    assert not tr.kernel_carries(cfg)
    tpb = window["tpb"]
    s = teng.batch_init(tpb, cfg)
    rows = [0, 2]
    out = tr.outputs("pop", cfg, 3, tpb.n_data_padded, "cpu")
    assert out["lanes"]["cvals"].shape[-1] == 16
    got = tr.advance("pop", cfg, tpb, s, rows, tables=None, out=out)
    want = tr.advance_plain("pop", cfg, tpb, s, rows)
    for j, w in enumerate(rows):
        for k in ("pts", "mrd", "active", "R_lanes", "converged"):
            _equal(got[k][w], want[k][j], k)
        for k, v in want["lanes"].items():
            _equal(got["lanes"][k][w], v[j], f"lanes {k}")


def test_router_and_plain_counter():
    """The transition takes the kernel exactly where the inner step
    kernel does; the torch transition counts its rows only on the card."""
    cfg = _port_cfg(_jcfg(1))
    assert tr.route(cfg, torch.zeros(1)) == "plain"
    for over, carried in ((dict(), True), (dict(regularization=0.0), True),
                          (dict(chem_survivors=4), False),
                          (dict(regularizationNeighbors=1e-3), False),
                          (dict(regularizationFPFH=1e-3, cfpfh=1), False)):
        c = dataclasses.replace(cfg, **over)
        assert tr.kernel_carries(c) == carried == tinner.kernel_carries(c)
    before = tr.plain_on_card["rows"]
    tr._count_plain(torch.zeros(1), 3)
    assert tr.plain_on_card["rows"] == before


# ---------------------------------------------------------------------------
# the kernels on the card (skip without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(got, want) -> bool:
    g, w = got.cpu(), want.cpu()
    if g.dtype == torch.float32:
        return g.shape == w.shape and bool(torch.all(
            (g.view(torch.int32) == w.view(torch.int32))
            | (torch.isnan(g) & torch.isnan(w))))
    return torch.equal(g, w)


def _all_same(got: dict, want: dict, where: str):
    for k, w in want.items():
        if isinstance(w, dict):
            _all_same(got[k], w, f"{where} {k}")
        elif isinstance(w, torch.Tensor):
            assert _same(got[k], w), f"{where}: {k}"


@pytest.mark.cuda
@pytest.mark.parametrize("case,how,reuse",
                         [c for c in STREAM_CASES if c[0] != "out_of_order"])
def test_stream_kernels_equal_plain(window, card, case, how, reuse):
    cfg = _port_cfg(_jcfg(reuse))
    state = window["state"]
    if not reuse:
        state = dict(state, inner={k: v for k, v in state["inner"].items()
                                   if k != "cvals"})
    ts0 = tfs.stream_state_from_jax(state, "cpu")
    h0 = tr.harvest_plain(ts0, range(ts0["opt_err"].shape[0]))
    s = _edit(state, case, {k: h0[k].numpy() for k in ("lb_safe",
                                                       "cand_ub")})
    ts = tfs.stream_state_from_jax(s, card)
    rows = [w for w in range(ts["opt_err"].shape[0])
            if not bool(ts["converged"][w])]
    _sorted_rest(ts["fr_lbs"][rows].cpu())        # the merge's precondition
    tpb = window["tpb"].to(card)
    h = tr.harvest(cfg, ts, rows)
    _all_same(h, tr.harvest_plain(ts, rows), "harvest")
    r = tr.refine_rows(len(rows), card) if how != "none" else None
    if r is not None:
        tr.set_refine(r, 0, dict(
            icp_R=torch.eye(3, device=card), icp_t=torch.zeros(3, device=card),
            icp_err=h["incumbent"][0] * (0.5 if how == "icp" else 2.0),
            icp_terms=torch.ones(3, device=card),
            icp_incomp=torch.tensor(3, device=card),
            bnb_comp=torch.tensor(2, device=card)))
    tabs = tfs._transition_tables(tpb, cfg)
    got = tr.advance("both", cfg, tpb, ts, rows, tables=tabs, h=h, r=r)
    want = tr.advance_plain("both", cfg, tpb, ts, rows, h=h, r=r)
    _all_same(got, want, "advance both")
    # in place, into a copy of the window: the same rows
    win = tfs._map_state(torch.clone, ts)
    tr.advance("both", cfg, tpb, win, rows, tables=tabs, h=h, r=r, out=win)
    _all_same({k: v[rows] for k, v in win.items() if k != "inner"},
              {k: v for k, v in want.items() if k != "inner"}, "in place")
