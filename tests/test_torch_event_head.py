"""The fused stream's event head and the harvest an inner run makes at its
end (goicp_tpu_torch/search/transition.py: event_head_plain, event_head,
read_event; search/inner.py::inner_run(head=); on the card
csrc/harvest_body.cuh inside csrc/inner.cu and csrc/transition.cu).

On the CPU:
  * the plain event head against the composition the stream ran before
    it (the flags stacked in torch, the inner search's completion,
    np.nonzero(...)[:K], harvest_plain), bit for bit, on a window of the
    port's stream: as run, a NaN ub, every ub inf, converged rows, no row
    complete, every row served and K = 1 (trans_slots < W);
  * its harvest against the JAX package's vmapped _harvest
    (goicp_tpu/search/fused_stream.py:131) on the same window, exactly
    (minima, copies and one halving);
  * a fused chunk reads the host once a transition event and once to end,
    and equals, bit for bit in every state leaf, the loop it replaces (a
    harvest and a read of its flags an event, the masks in torch ops), at
    icp_on_improve 1 and 0, trans_slots 1 and eager;
  * the slot blocks of goicp_inner_run with a head and of goicp_harvest's
    event mode, through a recorder in place of the C functions.
The tests marked `cuda` hold the kernels to the plain twin and to the run
followed by the standalone harvest, bit for bit, at 2 or 3 rows and at
288 (more than 256 groups, rows harvested); and a fused stream of 288
rows to its 3 rows alone.  They skip without a card.  JAX is imported
inside the CPU tests only, so on a card's machine `python -m pytest
--noconftest tests/test_torch_event_head.py -m cuda` runs the card's
tests alone."""

import dataclasses

import numpy as np
import pytest
import torch

from goicp_tpu_torch import config as tconfig
from goicp_tpu_torch.bounds import cuda_eval
from goicp_tpu_torch.search import fused_stream as tfs
from goicp_tpu_torch.search import inner as tinner
from goicp_tpu_torch.search import transition as tr
from goicp_tpu_torch.search.args import (HARVEST_KEYS, RunHead,
                                         TransitionBuffers, harvest_rows_of)

# small torch ops in a loop: intra-op threads only contend with the
# parallel test workers (see test_torch_device_engine.py)
torch.set_num_threads(1)

STEPS = 6           # JAX global iterations before the compared event
CR = 64             # device_rot_capacity
CASES = ("as run", "NaN ub", "all-inf ubs", "converged rows",
         "none complete")


def _port_window(dev, W=3, steps=STEPS, tile=1):
    """W pairs (48 points, S 12) prepared by the port on `dev`, one
    bucket, the window of them repeated `tile` times, and its state
    `steps` global iterations in (the port's fused stream)."""
    from goicp_tpu_torch.bench.measure import _bucket_and_prepare
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    cfg = tconfig.GoICPConfig(
        MSEThresh=0.01, regularization=0.0005, ponderation=1, rot_batch=1,
        trans_capacity=16, trans_pop=2, inner_max_iters=60,
        device_rot_capacity=CR, max_outer_steps=300, icp_seeds=2,
        icp_max_iter=60, distTransSize=12)
    rng = np.random.default_rng(5)
    raw = []
    for _ in range(W):
        tgt = rng.uniform(-0.8, 0.8, size=(48, 3))
        src = (tgt[:40] - 0.05) @ rodrigues_np(rng.uniform(-1, 1, 3)).T
        props = rng.integers(0, 9, size=48).astype(np.int32)
        raw.append((src, tgt, props[:40], props))
    pb = stack_pairs(_bucket_and_prepare(raw, cfg, device=dev) * tile)
    return cfg, pb, tfs.fused_run_chunk(pb, cfg, tfs._init_batch(pb, cfg),
                                        steps)


@pytest.fixture(scope="module")
def window():
    """Three pairs and the port's window state after STEPS global
    iterations, on the CPU."""
    cfg, pb, state = _port_window("cpu")
    return dict(cfg=cfg, state=state, tpb=pb)


def _state(window) -> dict:
    return tfs._map_state(torch.clone, window["state"])


def _edit(s: dict, case: str) -> dict:
    """A copy of the port's window state edited into `case` (row 0)."""
    s = tfs._map_state(torch.clone, s)
    ist = s["inner"]
    if case in ("NaN ub", "all-inf ubs"):
        s["converged"][0] = False        # row 0 complete and served
        ist["done"][0] = True
    if case == "NaN ub":
        s["active"][0, 0] = True
        ist["opt_err"][0, 0] = float("nan")
    elif case == "all-inf ubs":
        s["active"][0] = False
    elif case == "converged rows":
        ist["done"][:] = True
        s["converged"][0] = True
        s["converged"][2] = True
    elif case == "none complete":
        ist["done"][:] = False
        ist["it"][:] = 0
    else:
        ist["done"][1] = True            # rows 1 (and any other) complete
    return s


def _old_composition(cfg, s, K):
    """The event as fused_run_chunk formed it before the event head: the
    flags stacked in torch, the rows by np.nonzero, harvest_plain."""
    finished = s["converged"] | (s["it"] >= cfg.max_outer_steps)
    complete = torch.all(s["inner"]["done"], dim=-1) \
        | (s["inner"]["it"] >= cfg.inner_max_iters)
    flags = torch.stack([finished, s["converged"], complete]).numpy()
    rows = np.nonzero(flags[2] & ~flags[1])[0][:K]
    h = tr.harvest_plain(s, rows) if len(rows) else None
    return flags, [int(r) for r in rows], h


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
        nan = np.isnan(np.asarray(want).view(np.float32))
        got, want = np.where(nan, 0, got), np.where(nan, 0, want)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("K", [3, 1])
def test_event_head_plain_equals_the_old_composition(window, case, K):
    cfg = window["cfg"]
    s = _edit(_state(window), case)
    fin0 = torch.ones((3,), dtype=torch.bool)
    ev = tr.event_head_plain(cfg, s, K, n_iters=5, fin0=fin0)
    e = tr.read_event(ev, 3, K)
    flags, rows, h = _old_composition(cfg, s, K)
    _same(e.finished, flags[0], "finished")
    _same(e.converged, flags[1], "converged")
    _same(e.complete, flags[2], "complete")
    _same(fin0.numpy(), flags[0], "fin0")
    assert e.rows == rows and e.n_iters == 5
    if case == "none complete":
        assert rows == []
    if case in ("NaN ub", "all-inf ubs"):
        assert rows[0] == 0
    if not rows:
        return
    _same(e.improved, h["flags"][:, 0].numpy(), "improved")
    got = harvest_rows_of(ev, len(rows))
    for k in HARVEST_KEYS + ("improved",):
        _same(got[k].numpy(), h[k].numpy(), k)
    if case == "NaN ub":
        assert np.isnan(float(got["cand_ub"][0])) and bool(got["improved"][0])
    if case == "all-inf ubs":
        assert float(got["cand_ub"][0]) == float("inf") \
            and not bool(got["improved"][0])


def test_event_head_harvest_equals_jax(window):
    import jax
    import jax.numpy as jnp
    from goicp_tpu.search import fused_stream as jfs
    cfg = window["cfg"]
    s = _state(window)
    # every row complete: some by its inner it (its lanes' frontiers
    # scanned), the others with every lane done
    s["inner"]["it"][:] = cfg.inner_max_iters
    s["converged"][:] = False
    ev = tr.event_head_plain(cfg, s, 3)
    e = tr.read_event(ev, 3, 3)
    assert e.rows == [0, 1, 2]
    js = {"inner": {k: jnp.asarray(s["inner"][k].numpy()) for k in (
        "lbs", "thr", "min_dropped", "done", "opt_err", "best_node",
        "ub_terms")},
        "active": jnp.asarray(s["active"].numpy()),
        "R_lanes": jnp.asarray(s["R_lanes"].numpy())}
    want = jax.tree_util.tree_map(np.asarray, jax.vmap(
        lambda st: jfs._harvest(None, None, st))(js))
    got = harvest_rows_of(ev, 3)
    for k in ("lb_safe", "ubs", "cand_ub", "cand_R", "cand_t", "cand_terms"):
        _same(got[k].numpy(), want[k], k)


def _old_chunk(pair_batch, cfg, state, steps, eager=False):
    """fused_run_chunk as it ran before the event head: a read of the
    flags (with the run's iterations) and a harvest and a read of its
    flags a transition event, the masks in torch ops."""
    s = tfs._map_state(torch.clone, state)
    W, L = s["inner"]["done"].shape
    K = tfs._trans_budget(cfg, W)
    tables = tfs._window_tables(pair_batch, cfg, L)
    fin0 = fin0_dev = None
    g = n = 0
    reads = 0
    while True:
        finished = s["converged"] | (s["it"] >= cfg.max_outer_steps)
        complete = torch.all(s["inner"]["done"], dim=-1) \
            | (s["inner"]["it"] >= cfg.inner_max_iters)
        flags = torch.stack([finished, s["converged"], complete]).numpy()
        reads += 1
        g += n
        if fin0 is None:
            fin0, fin0_dev = flags[0].copy(), finished
        go = bool((~flags[0]).any()) and g < steps
        if eager:
            go = go and not bool((flags[0] & ~fin0).any())
        if not go:
            break
        rows = np.nonzero(flags[2] & ~flags[1])[0][:K]
        if len(rows):
            # the harvest and a read of which rows improved inside
            reads += int(bool(cfg.icp_on_improve))
            tfs._transition_batch(pair_batch, cfg, s, rows, in_place=True)
        live = ~s["converged"] & ~(torch.all(s["inner"]["done"], dim=-1) | (
            s["inner"]["it"] >= cfg.inner_max_iters))
        fin = s["converged"] | (s["it"] >= cfg.max_outer_steps)
        once = torch.all(fin)
        if eager:
            once = once | torch.any(fin & ~fin0_dev)
        s["inner"], n = tfs._inner_run(pair_batch, cfg, s, tables, "stream",
                                       live=live, watch=~s["converged"],
                                       once=once, steps=steps - g)
    return s, reads


@pytest.mark.parametrize("over,eager", [
    ({}, False), (dict(icp_on_improve=0), False),
    (dict(trans_slots=1), True)])
def test_fused_chunk_reads_once_an_event(window, over, eager):
    cfg = dataclasses.replace(window["cfg"], **over)
    pb = window["tpb"]
    init = tfs._init_batch(pb, cfg)
    tfs.reset_counters()
    got = tfs.fused_run_chunk(pb, cfg, init, 14, eager=eager)
    c = dict(tfs.counters)
    want, old_reads = _old_chunk(pb, cfg, init, 14, eager=eager)
    assert c["chunks"] == 1 and c["transitions"] > 0
    assert c["host_reads"] == c["transitions"] + 1
    assert old_reads > c["host_reads"] or not cfg.icp_on_improve
    got_leaves, want_leaves = dict(tfs._flat_items(got)), \
        dict(tfs._flat_items(want))
    assert set(got_leaves) == set(want_leaves)
    for k, v in want_leaves.items():
        _same(got_leaves[k].numpy(), v.numpy(), k)


# ---------------------------------------------------------------------------
# the slot blocks, through a recorder
# ---------------------------------------------------------------------------

class _Recorder:
    """The C functions' stand-in: records each call's slots and ints."""

    def __init__(self):
        self.calls = []

    def goicp_inner_run(self, slots, n_slots, ints, n_ints, reg, stream):
        self.calls.append((list(slots)[:n_slots], list(ints)[:n_ints]))
        return 0

    def goicp_harvest(self, slots, n_slots, ints, n_ints, rows, n, stream):
        self.calls.append((list(slots)[:n_slots], list(ints)[:n_ints]))
        return 0


@pytest.fixture
def kernel_route(monkeypatch):
    rec = _Recorder()
    for mod in (tinner, tr):
        monkeypatch.setattr(mod, "kernels", rec)
        monkeypatch.setattr(mod, "_stream", lambda x: 0)
    monkeypatch.setattr(cuda_eval, "_route", lambda x: "cuda")
    monkeypatch.setattr(tr, "route", lambda cfg, x: "kernel")
    return rec


def _run_case(window):
    """The window's lanes as one run's input (W groups of L lanes)."""
    cfg = window["cfg"]
    s = _state(window)
    W, L = s["inner"]["done"].shape
    tables = tfs._window_tables(window["tpb"], cfg, L)
    lanes = {k: s["inner"][k] for k in tinner._PER_LANE if k in s["inner"]}
    pts = s["pts_rot"].reshape((W * L,) + s["pts_rot"].shape[2:])
    counters = {k: s["inner"][k] for k in tinner._COUNTERS}
    return cfg, s, tables, lanes, pts, s["mrd"].reshape(W * L, -1), counters


@pytest.mark.parametrize("mode", ["stream", "groups", "search"])
def test_inner_run_head_slots_through_a_recorder(window, kernel_route,
                                                 mode):
    cfg, s, tables, lanes, pts, mrd, counters = _run_case(window)
    W = s["converged"].shape[0]
    fin0 = torch.zeros((W,), dtype=torch.bool)
    if mode == "stream":
        head = RunHead(s["active"], s["R_lanes"], s["opt_err"],
                       s["converged"], it=s["it"], fin0=fin0, K=2,
                       max_outer=cfg.max_outer_steps, eager=True)
        kw = dict(groups=W, counters=counters, steps=9)
    elif mode == "groups":
        head = RunHead(s["active"], s["R_lanes"], s["opt_err"],
                       s["converged"],
                       rows=torch.tensor([0, 2], dtype=torch.int32))
        kw = dict(groups=W, counters=counters)
    else:
        # every lane one group, the window's lanes as one row's
        head = RunHead(s["active"].reshape(1, -1),
                       s["R_lanes"].reshape(1, -1, 3, 3), s["opt_err"][:1],
                       s["converged"][:1],
                       rows=torch.zeros((1,), dtype=torch.int32))
        W = 1
        kw = {}
    bufs = TransitionBuffers()
    for _ in range(3):
        r = tinner.inner_run(tables, cfg, lanes, pts, mrd, True, mode,
                             bufs=bufs, head=head, **kw)
    slots, ints = kernel_route.calls[-1]
    assert len(slots) == 63 and len(ints) == 22
    n_rows = 0 if head.rows is None else head.rows.numel()
    assert ints[17:22] == [2 if mode == "stream" else 1, head.K,
                           head.max_outer, int(head.eager), n_rows]
    # the rows harvested: a slot (device memory), any number of them
    assert slots[62] == (0 if head.rows is None else head.rows.data_ptr())
    assert slots[47:51] == [x.data_ptr() for x in (
        head.active, head.R_lanes, head.opt_err, head.conv)]
    h = r.head["h"]
    assert slots[53] == h["lb_safe"].data_ptr()
    assert h["lb_safe"].shape == (head.K if mode == "stream" else W,
                                  lanes["done"].numel() // W)
    if mode == "stream":
        assert slots[51:53] == [s["it"].data_ptr(), fin0.data_ptr()]
        assert slots[21:24] == [0, 0, 0]          # the masks from the state
        assert slots[61] == r.head["words"].data_ptr()
        assert r.head["words"].numel() == tr.event_words(W, 2)
    else:
        assert slots[51:53] == [0, 0] and slots[61] == 0
    # the block kept for each set: nothing re-checked on the third call
    assert sorted(b.rechecked for b in bufs.blocks.values()) == [0, 0]
    with pytest.raises(ValueError, match="head"):
        tinner.inner_run(tables, cfg, lanes, pts, mrd, True,
                         "search" if mode == "stream" else "stream",
                         head=head, steps=3)


def test_event_head_slots_through_a_recorder(window, kernel_route):
    cfg = window["cfg"]
    s = _state(window)
    fin0 = torch.zeros((3,), dtype=torch.bool)
    bufs = TransitionBuffers()
    ev = tr.event_head(cfg, s, 2, n_iters=4, fin0=fin0, bufs=bufs)
    slots, ints = kernel_route.calls[-1]
    assert len(slots) == 24
    assert ints == [s["active"].shape[1], cfg.trans_capacity, 3, 2,
                    cfg.max_outer_steps, cfg.inner_max_iters, 4]
    assert slots[:4] == [s["inner"][k].data_ptr()
                         for k in ("lbs", "thr", "min_dropped", "done")]
    assert slots[4] == 0                          # lb_safe not given
    assert slots[11] == s["converged"].data_ptr()
    assert slots[20:24] == [s["it"].data_ptr(), s["inner"]["it"].data_ptr(),
                            ev["words"].data_ptr(), fin0.data_ptr()]
    assert ev["h"]["lb_safe"].shape == (2, s["active"].shape[1])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(ev, n):
    out = {k: ev["h"][k][:n] for k in HARVEST_KEYS}
    if ev.get("words") is not None:
        out["words"] = ev["words"]
    return {k: v.cpu().numpy() for k, v in out.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_event_head_kernel_equals_plain(card, case):
    cfg, pb, s0 = _port_window(card, W=3, steps=12)
    s = _edit(s0, case)
    for K in (3, 1):
        fk, fp = (torch.zeros((3,), dtype=torch.bool, device=card)
                  for _ in range(2))
        ev = tr.event_head(cfg, s, K, n_iters=7, fin0=fk)
        want = tr.event_head_plain(cfg, s, K, n_iters=7, fin0=fp)
        n = len(tr.read_event(want, 3, K).rows)
        got, exp = _rows(ev, n), _rows(want, n)
        for k in exp:
            _same(got[k], exp[k], f"{case} K {K} {k}")
        _same(fk.cpu().numpy(), fp.cpu().numpy(), "fin0")


# the windows of the card's stream tests: 2 rows, and 3 pairs repeated to
# 288 rows (more groups than a word's bits many times over)
WINDOWS = [(2, 1), (3, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("W0,tile", WINDOWS)
@pytest.mark.parametrize("eager", [False, True])
def test_stream_run_with_its_event_head_equals_run_then_event(card, eager,
                                                              W0, tile):
    cfg, pb, s = _port_window(card, W=W0, steps=12, tile=tile)
    W, L = s["inner"]["done"].shape
    tables = tfs._window_tables(pb, cfg, L)
    fin0 = torch.zeros((W,), dtype=torch.bool, device=card)
    for steps in (40, 1):
        a, na, eva = tfs._inner_run(pb, cfg, s, tables, "stream",
                                    steps=steps, head=RunHead(
                                        s["active"], s["R_lanes"],
                                        s["opt_err"], s["converged"],
                                        it=s["it"], fin0=fin0, K=W,
                                        max_outer=cfg.max_outer_steps,
                                        eager=eager))
        live, watch, once = tfs._stream_masks(cfg, s, fin0, eager)
        b, nb = tfs._inner_run(pb, cfg, s, tables, "stream", live=live,
                               watch=watch, once=once, steps=steps)
        evb = tr.event_head(cfg, dict(s, inner=b), W, n_iters=nb)
        assert int(na) == int(nb)
        for k in b:
            _same(a[k].cpu().numpy(), b[k].cpu().numpy(), k)
        n = len(tr.read_event(evb, W, W).rows)
        got, exp = _rows(eva, n), _rows(evb, n)
        for k in exp:
            _same(got[k], exp[k], f"steps {steps} {k}")


@pytest.mark.cuda
def test_fused_stream_past_256_rows_equals_its_rows_alone(card):
    """A window of 288 rows (3 pairs repeated) steps each row as the
    3-row window steps it: every state leaf of row r equals row r % 3's."""
    _, _, small = _port_window(card, W=3, steps=40)
    _, _, big = _port_window(card, W=3, steps=40, tile=96)
    want, got = dict(tfs._flat_items(small)), dict(tfs._flat_items(big))
    for k, v in want.items():
        v = v.cpu().numpy()
        _same(got[k].cpu().numpy(),
              np.concatenate([v] * 96) if v.ndim else v, k)


def _groups_run_check(cfg, pb, rows):
    """The batch engine's pop of the batch rows `rows`, its groups run
    with the harvest at its end against the run without it followed by
    the standalone harvest."""
    from goicp_tpu_torch.search import device_engine as eng
    dev = pb.device
    B = pb.data.shape[0]
    s = eng.batch_init(pb, cfg)
    tab = tfs._window_tables(pb, cfg, cfg.rot_batch * 8)
    pop = tr.outputs("pop", cfg, B, pb.n_data_padded, dev)
    pop["lanes"]["done"].fill_(True)
    p = tr.advance("pop", cfg, pb, s, rows, tables=tab, out=pop)
    cnt = torch.zeros((4, B), dtype=torch.int32, device=dev)
    bs = dict(inner=dict(p["lanes"], it=cnt[0], evals=cnt[1],
                         geom_surv=cnt[2], chem_corners=cnt[3]),
              pts_rot=p["pts"], mrd=p["mrd"])
    a, na, ha = tfs._inner_run(pb, cfg, bs, tab, "groups", head=RunHead(
        p["active"], p["R_lanes"], s["opt_err"], p["converged"],
        rows=torch.tensor(rows, dtype=torch.int32, device=dev)))
    b, nb = tfs._inner_run(pb, cfg, bs, tab, "groups")
    hb = tr.harvest(cfg, dict(inner=b, active=p["active"],
                              R_lanes=p["R_lanes"], opt_err=s["opt_err"]),
                    rows, conv=p["converged"])
    assert int(na) == int(nb)
    for k in b:
        _same(a[k].cpu().numpy(), b[k].cpu().numpy(), k)
    got, exp = _rows(ha, len(rows)), _rows(dict(h=hb), len(rows))
    for k in exp:
        _same(got[k], exp[k], f"{len(rows)} rows {k}")


@pytest.mark.cuda
def test_search_and_groups_runs_harvest_at_their_end(card):
    from goicp_tpu_torch.search import device_engine as eng
    cfg, pb, _ = _port_window(card, W=3, steps=12)
    pair = tfs._pair_row(pb, 0)
    st = eng.device_run_chunk(pair, cfg, eng.device_init(pair, cfg), 3)
    p = eng._pop(pair, cfg, st)
    args = (pair, cfg, p["pts"], p["widths"], p["active"], st["opt_err"],
            False, True)
    kw = dict(lanes0=p["lanes"], mrd=p["mrd"], raw=True)
    ra, la, ha = tinner.inner_bnb(*args, head=RunHead(
        p["batch"]["active"], p["batch"]["R_lanes"],
        st["opt_err"].reshape(1), p["batch"]["converged"],
        rows=torch.zeros((1,), dtype=torch.int32, device=card)), **kw)
    rb, lb_ = tinner.inner_bnb(*args, **kw)
    hb = tr.harvest(cfg, eng._harvest_src(p, st["opt_err"], rb), [0],
                    lb=eng._lb_lanes(lb_), conv=p["batch"]["converged"])
    for k in lb_:
        _same(la[k].cpu().numpy(), lb_[k].cpu().numpy(), k)
    got, exp = _rows(ha, 1), _rows(dict(h=hb), 1)
    for k in exp:
        _same(got[k], exp[k], k)
    # the batch engine's groups run: rows 0 and 2 of 3 stepping, and 287
    # of 288 (3 pairs repeated)
    _groups_run_check(cfg, pb, [0, 2])
    _, big, _ = _port_window(card, W=3, steps=1, tile=96)
    _groups_run_check(cfg, big, [r for r in range(288) if r != 5])
