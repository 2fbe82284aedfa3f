"""The inner run at the kernel's interface (goicp_tpu_torch/search/
inner.py::inner_run_plain, the CPU's route and the yardstick of
csrc/inner.cu's goicp_inner_run) in its three stop modes:

  search: held to the JAX package's inner_bnb on the same pair (per-lane
    results within 1e-5 relative as in test_torch_inner.py, best_node and
    every counter exact), and its chem_corners to the stage-width rule the
    kernel applies (corners_per_lane x the staged compaction's width for
    the lanes active before each iteration, the compaction itself changing
    no lane: the same lanes as stepping at full width);
  stream: fused_run_chunk, which now runs the global iterations between
    two transitions as one inner run, held to the loop it replaces (one
    inner step and one host read a global iteration) bit for bit in every
    state leaf, global iterations and transitions, with a steps cap and
    with trans_slots=1, and to the JAX package's fused_run_chunk on the
    same window state;
  groups: the batch engine's run held to its loop of single steps.

The tests marked `cuda` hold the kernel to the plain run on the card and
check that it refuses a configuration it does not carry; they skip
without a card.  JAX is imported only inside the CPU tests, so those run
on a card's machine alone: `python -m pytest --noconftest
tests/test_torch_inner_run.py -m cuda`."""

import dataclasses

import numpy as np
import pytest
import torch

from goicp_tpu_torch import config as tconfig
from goicp_tpu_torch.bounds.evaluate import rot_uncertainty
from goicp_tpu_torch.search import fused_stream as tfs
from goicp_tpu_torch.search import inner as tinner

# small torch ops in a loop: intra-op threads only contend with the
# parallel test workers (see test_torch_device_engine.py)
torch.set_num_threads(1)

INC = 40.0
ACTIVE = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
BASE = {"MSEThresh": 0.01, "regularization": 0.0005, "ponderation": 1,
        "distTransSize": 12, "trans_capacity": 64, "trans_pop": 4,
        "inner_max_iters": 200, "chem_reuse": 1, "lane_compaction": 1}


def _port_cfg(cfg, **over):
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(tconfig.GoICPConfig)}
    kw.update(over)
    return tconfig.GoICPConfig(**kw)


def _case(seed=1, n=40, trim=0.0, dynamic=False, **kw):
    """A pair of <= 64 points in both packages (test_torch_inner.py's
    case), 8 rotated lanes and their rotation widths."""
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.geom.rotation import rodrigues_np
    from goicp_tpu.pipeline import prepare as jprep
    cfg = GoICPConfig(**{**BASE, "trimFraction": trim, **kw})
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


def _stage_rule_corners(cfg, L, actives, per_lane):
    """The kernel's chem_corners in mode search: per iteration
    corners_per_lane x the width of the stage the staged compaction runs
    it in, from the lanes active before it (csrc/inner.cu run_counters)."""
    widths = tinner._stage_widths(cfg, L) + [0, 0]
    w1, w2 = widths[1], widths[2]
    total = 0
    for n in actives:
        width = L
        if w1 > 0 and n <= w1:
            width = w2 if w2 > 0 and n <= w2 else w1
        total += per_lane * width
    return total


def _full_width(tp, cfg, lanes, pts, mrd, fused):
    """The search stepped at full width (no compaction): the lanes active
    before each iteration, and the final lanes."""
    actives = []
    it = 0
    while it < cfg.inner_max_iters:
        n = int((~lanes["done"]).sum())
        if n == 0:
            break
        actives.append(n)
        lanes, _, st = tinner.inner_step_plain(tp, cfg, lanes, pts, mrd,
                                               fused)
        it += 1
    return actives, lanes, st.corners_per_lane if actives else 0


@pytest.mark.parametrize("variant", [
    dict(fused=True),                  # lane_compaction 1, sorted_merge 0
    dict(fused=True, cfg=dict(lane_compaction=0, sorted_merge=1)),
    dict(fused=True, trim=0.1, dynamic=True),
    dict(fused=False, unc=True),       # the two-pass engine's lb pass
    # its ub pass, cut at inner_max_iters
    dict(fused=False, unc=False, cfg=dict(inner_max_iters=5), cut=True),
])
def test_search_mode_matches_jax_inner_bnb(variant):
    import jax.numpy as jnp
    from goicp_tpu.search import inner as jinner
    from goicp_tpu_torch.pipeline.prepare import pair_from_jax
    cfg, jp, pts_np, widths_np = _case(
        trim=variant.get("trim", 0.0), dynamic=variant.get("dynamic", False),
        **variant.get("cfg", {}))
    tcfg = _port_cfg(cfg)
    tp = pair_from_jax(jp, "cpu")
    fused, unc = variant["fused"], variant.get("unc", False)
    pts, widths = torch.as_tensor(pts_np), torch.as_tensor(widths_np)
    want = jinner.inner_bnb(jp, cfg, jnp.asarray(pts_np),
                            jnp.asarray(widths_np), jnp.asarray(ACTIVE),
                            jnp.float32(INC), with_rot_uncertainty=unc,
                            fused=fused)
    mrd = rot_uncertainty(widths, tp.norm_data) if (fused or unc) else None
    lanes0 = tinner.initial_lanes(tp, tcfg, pts, torch.as_tensor(ACTIVE),
                                  torch.tensor(INC))
    got = tinner.inner_run_plain(tp, tcfg, lanes0, pts, mrd, fused, "search")
    cnt = got.counters
    assert got.iters == int(want.iters) == int(cnt["it"])
    for k in ("evals", "geom_surv", "chem_corners"):
        assert int(cnt[k]) == int(getattr(want, k)), k
    s = got.lanes
    np.testing.assert_array_equal(s["best_node"].numpy(),
                                  np.asarray(want.best_node))
    lb_safe = torch.minimum(s["thr"] if fused else s["opt_err"],
                            s["min_dropped"])
    lb_safe = torch.where(s["done"], lb_safe, torch.minimum(
        lb_safe, torch.amin(s["lbs"], dim=1)))
    for name, g, w in (("best_err", s["opt_err"], want.best_err),
                       ("ub_terms", s["ub_terms"], want.ub_terms),
                       ("lb_safe", lb_safe, want.lb_safe)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)

    # the kernel's rule for chem_corners, and the compaction changes no lane
    actives, full, per_lane = _full_width(tp, tcfg, lanes0, pts, mrd, fused)
    assert len(actives) == got.iters
    assert _stage_rule_corners(tcfg, 8, actives, per_lane) \
        == int(cnt["chem_corners"])
    for k, v in full.items():
        assert torch.equal(v, s[k]), k
    if variant.get("cut"):
        assert got.iters == 5 and not bool(s["done"].all())
    else:
        # lanes end at different iterations
        assert bool(s["done"].all()) and len(set(actives)) > 2


def test_search_mode_over_two_pairs_keeps_each_lane_on_its_pair():
    """Lanes of two pairs interleaved (a LaneTables): the compaction takes
    each lane's pair along, so the run equals the full-width stepping."""
    from tests.test_torch_inner_step import _cfg, _two_pairs
    tcfg, _, pairs, tables, pts, mrd, lane_pair = _two_pairs(_cfg())
    s = tinner.initial_lanes(pairs[0], tcfg, pts, torch.as_tensor(ACTIVE),
                             torch.tensor(INC))
    sel = torch.nonzero(lane_pair == 1)[:, 0]
    s["cvals"][sel, 0] = tinner.root_corner_values(pairs[1], tcfg, pts[sel])
    got = tinner.inner_run_plain(tables, tcfg, s, pts, mrd, True, "search")
    actives, full, per_lane = _full_width(tables, tcfg, s, pts, mrd, True)
    assert got.iters == len(actives) > 2
    assert _stage_rule_corners(tcfg, 8, actives, per_lane) \
        == int(got.counters["chem_corners"])
    for k, v in full.items():
        assert torch.equal(v, got.lanes[k]), k


def test_search_mode_with_no_active_lane_runs_no_iteration():
    from goicp_tpu_torch.pipeline.prepare import pair_from_jax
    cfg, jp, pts_np, _ = _case()
    tcfg = _port_cfg(cfg)
    tp = pair_from_jax(jp, "cpu")
    pts = torch.as_tensor(pts_np)
    lanes0 = tinner.initial_lanes(tp, tcfg, pts,
                                  torch.zeros(8, dtype=torch.bool),
                                  torch.tensor(INC))
    got = tinner.inner_run_plain(tp, tcfg, lanes0, pts, None, True, "search")
    assert got.iters == 0 and int(got.counters["evals"]) == 0
    for k, v in lanes0.items():
        assert torch.equal(got.lanes[k], v), k


# ---------------------------------------------------------------------------
# the fused stream (mode stream) and the batch engine (mode groups)
# ---------------------------------------------------------------------------

def _per_iteration_chunk(pb, cfg, state, steps):
    """fused_run_chunk as the port ran it before the inner run: one inner
    step (fused_stream._inner_step) and one host read every global
    iteration.  -> (state, global iterations, the rows of every
    transition event)."""
    s = tfs._map_state(torch.clone, state)
    W, L = s["inner"]["done"].shape
    K = tfs._trans_budget(cfg, W)
    tables = tfs._window_tables(pb, cfg, L)
    g, events = 0, []
    while True:
        finished = s["converged"] | (s["it"] >= cfg.max_outer_steps)
        flags = torch.stack([finished, s["converged"],
                             tfs._inner_complete(cfg, s)]).numpy()
        if not ((~flags[0]).any() and g < steps):
            break
        rows = np.nonzero(flags[2] & ~flags[1])[0][:K]
        if len(rows):
            events.append(rows.tolist())
            tfs._transition_batch(pb, cfg, s, rows, in_place=True)
        live = ~s["converged"] & ~tfs._inner_complete(cfg, s)
        s["inner"] = tfs._inner_step(pb, cfg, s, tables, live)
        g += 1
    return s, g, events


def _leaves(state, prefix=""):
    for k, v in state.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _same_state(got, want):
    """Every leaf equal: float32 bit for bit (NaN to NaN), the rest
    exactly."""
    want = dict(_leaves(want))
    for k, g in _leaves(got):
        w = want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if g.dtype == torch.float32:
            assert torch.equal(torch.isnan(g), torch.isnan(w)), k
            assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w)), k
        else:
            assert torch.equal(g, w), k


@pytest.fixture(scope="module")
def window():
    """Two pairs in one window (the JAX package's small stream case on a
    12^3 grid; both converge after ~54 global iterations, their
    transitions mostly one row at a time), the JAX window state and the
    port's copy of it."""
    import jax
    from goicp_tpu.dist.mesh import stack_pairs as jstack_pairs
    from goicp_tpu.search import fused_stream as jfs
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.pipeline.prepare import pair_from_jax
    from tests.test_fused_stream import _pairs, _small_cfg
    jcfg = _small_cfg(distTransSize=12)
    jpairs = _pairs(jcfg, n=2, seed=5)
    jpb = jstack_pairs(jpairs)
    jstate = jfs._jit_init(jcfg)(jpb)
    return dict(jcfg=jcfg, jpb=jpb, jstate=jstate, cfg=_port_cfg(jcfg),
                pb=stack_pairs([pair_from_jax(p, "cpu") for p in jpairs]),
                start=tfs.stream_state_from_jax(jax.device_get(jstate),
                                                "cpu"))


@pytest.mark.parametrize("steps,slots", [(60, 0), (9, 0), (60, 1)])
def test_stream_mode_matches_the_per_iteration_loop(window, steps, slots):
    cfg = dataclasses.replace(window["cfg"], trans_slots=slots)
    want, g, events = _per_iteration_chunk(window["pb"], cfg,
                                           window["start"], steps)
    tfs.reset_counters()
    got = tfs.fused_run_chunk(window["pb"], cfg, window["start"], steps)
    _same_state(got, want)
    c = tfs.counters
    assert c["global_iters"] == g and c["transitions"] == len(events)
    if steps < 60:
        assert g == steps
    else:
        # the rows come due at different global iterations, and a run
        # covers several of them between two host reads
        assert g > 40 and any(len(e) == 1 for e in events)
        assert c["host_reads"] < g


def test_stream_mode_matches_jax_fused_run_chunk(window):
    import jax
    from goicp_tpu.search import fused_stream as jfs
    jcfg = dataclasses.replace(window["jcfg"], trans_slots=1)
    cfg = dataclasses.replace(window["cfg"], trans_slots=1)
    got = tfs.fused_run_chunk(window["pb"], cfg, window["start"], 30)
    want = jax.device_get(jfs.fused_run_chunk(window["jpb"], jcfg,
                                              window["jstate"],
                                              np.int32(30)))
    for k in ("it", "evals", "inner_it", "icp_runs", "converged", "active"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    for k in ("it", "evals", "geom_surv", "chem_corners", "done"):
        np.testing.assert_array_equal(got["inner"][k].numpy(),
                                      np.asarray(want["inner"][k]), k)
    for k in ("opt_err", "fr_lbs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("lbs", "opt_err", "thr", "nodes"):
        np.testing.assert_allclose(got["inner"][k].numpy(),
                                   np.asarray(want["inner"][k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_groups_mode_matches_the_batch_loop(window):
    """A window mid-run (rows at different points of their inner
    searches, counters not 0): the run to every row's complete search,
    held to the batch engine's former loop of single steps."""
    cfg = window["cfg"]
    s = tfs.fused_run_chunk(window["pb"], cfg, window["start"], 5)
    tables = tfs._window_tables(window["pb"], cfg, cfg.rot_batch * 8)
    got, n = tfs._inner_run(window["pb"], cfg, s, tables, "groups")
    want = dict(s)
    steps = 0
    while True:
        live = ~tfs._inner_complete(cfg, want)
        if not bool(torch.any(live)):
            break
        want["inner"] = tfs._inner_step(window["pb"], cfg, want, tables, live)
        steps += 1
    _same_state(got, want["inner"])
    assert n == steps > 1
    assert bool(tfs._inner_complete(cfg, dict(s, inner=got)).all())


# ---------------------------------------------------------------------------
# the kernel on the card (skips without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_pair(card, cfg):
    """A pair prepared by the port itself on the card (no JAX), 8 rotated
    lanes and their rotation uncertainty."""
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    from goicp_tpu_torch.pipeline.prepare import prepare_pair
    rng = np.random.default_rng(3)
    tgt = rng.uniform(-0.8, 0.8, size=(48, 3))
    src = (tgt[:40] - 0.05) @ rodrigues_np(rng.uniform(-1, 1, 3)).T
    props = rng.integers(0, 9, size=48).astype(np.int32)
    pair = prepare_pair(src, tgt, props[:40], props, cfg, pad_data_to=64,
                        device=card)
    rots = np.stack([rodrigues_np(v) for v in rng.uniform(-2, 2, (8, 3))])
    pts = torch.as_tensor(np.einsum("lij,nj->lni", rots,
                                    pair.data.cpu().numpy()),
                          dtype=torch.float32, device=card).contiguous()
    mrd = rot_uncertainty(torch.as_tensor(rng.uniform(0.2, 1.2, 8),
                                          dtype=torch.float32, device=card),
                          pair.norm_data)
    return pair, pts, mrd


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_carry(card):
    cfg = tconfig.GoICPConfig(**BASE, chem_survivors=8)
    assert not tinner.kernel_carries(cfg)
    pair, pts, mrd = _card_pair(card, cfg)
    lanes = tinner.initial_lanes(pair, cfg, pts, torch.as_tensor(
        ACTIVE, device=card), torch.tensor(INC, device=card))
    before = tinner.inner_run.launches
    with pytest.raises(ValueError, match="kernel_carries"):
        tinner.inner_run(pair, cfg, lanes, pts, mrd, True, "search")
    assert tinner.inner_run.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, dict(sorted_merge=1),
                                  dict(inner_max_iters=5)])
def test_kernel_equals_plain_run(card, over):
    cfg = tconfig.GoICPConfig(**{**BASE, **over})
    pair, pts, mrd = _card_pair(card, cfg)
    lanes = tinner.initial_lanes(pair, cfg, pts, torch.as_tensor(
        ACTIVE, device=card), torch.tensor(INC, device=card))
    got = tinner.inner_run(pair, cfg, lanes, pts, mrd, True, "search")
    want = tinner.inner_run_plain(pair, cfg, lanes, pts, mrd, True, "search")
    assert int(got.iters) == want.iters
    for k, w in want.counters.items():
        assert torch.equal(got.counters[k].cpu(), w.cpu()), k
    for k, w in want.lanes.items():
        g = got.lanes[k]
        assert torch.equal(g.cpu().view(torch.uint8),
                           w.cpu().view(torch.uint8)), k
