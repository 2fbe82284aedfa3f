"""Cross-pair fused stream engine: ONE loop advances EVERY pair.

Port of goicp_tpu/search/fused_stream.py.  A window of W pairs is in flight
at once.  Every GLOBAL iteration advances each in-flight pair by one
inner-BnB iteration; outer-step transitions (harvest the finished inner
search -> ICP -> adopt -> prune/merge -> pop the next rotation parents ->
rotate -> fresh inner state) happen PER PAIR, asynchronously, whenever that
pair's inner search completes.  The sequential depth of a window is the max
over pairs of that pair's OWN (inner iterations + outer transitions).

The JAX package writes the engine as per-pair functions under jax.vmap
inside one lax.while_loop.  Here the batch axes are written out:

  * the inner iterations, one every global iteration, take the window's
    (W, L) lanes as W*L lanes (search/inner.py::inner_run, mode
    "stream"): lanes of different pairs read their own pair's tables
    through a LaneTables, and on the card every global iteration up to
    the next one at which a transition is due is ONE launch of
    csrc/inner.cu whatever W, the rows that are not live kept and their
    counters advanced (the plain loop of the torch body on the CPU).
    Configurations with FPFH or neighbour chem terms, which the per-lane
    tables do not carry, run the body once per window row instead;
  * the transition, which is rare, serves every transitioning row of
    the event at once (search/transition.py: on the card one harvest
    launch, one host read, the refine of the rows that improved
    (search/pick.py: three launches a row, into the loop's refine
    record), and one advance launch that writes the rows' new state into
    the window in place).  Rows that do not transition, and rows that
    converged, are not touched.

The loop is a Python loop over transition events: it reads ONE small
tensor on the host (which rows finished, which completed their inner
search, and how many global iterations the last inner run made), and a
transition event reads one more (which of its rows improved) before it
decides about ICP.  `counters` counts both.

Epsilon-optimality bookkeeping is identical to search/device_engine.py
(same pop/threshold-discard/prune rules, same min-dropped-lb folding into
the reported gap); per pair the trajectory is register_device's.

Frontier-capacity escalation (escalate_capacity): a row still in flight
after N chunks leaves the window, its translation frontier widened without
loss (migrate_row_capacity), and finishes in a deferred phase at the deeper
capacity.

With a mesh (dist/mesh.py) the window's rows split over the `data` axis:
each data rank advances its block of rows, and the per-chunk flags are
all-gathered, so that every rank makes the same refill, retirement and
handoff decisions.  When the window has drained to one live pair and no
refill remains, that pair's state moves to rotation-lane sharding over the
`search` axis (straggler_to_lane_sharded).

Reference anchors: OuterBnB/InnerBnB nesting jly_goicp.cpp:582-876 /
:286-579 (one pair, one node at a time); the pair loop bo1_GoICP.py:40-54.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from goicp_tpu_torch.bounds.evaluate import lane_tables, only_incomp
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.dist.mesh import stack_pairs
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.search.device_engine import (DeviceResult,
                                                  _initial_incumbent,
                                                  result_to_numpy)
from goicp_tpu_torch.search import pick, transition
from goicp_tpu_torch.search.args import TransitionBuffers
from goicp_tpu_torch.search.inner import (_COUNTERS, _PER_LANE,
                                          _chem_active, inner_iteration,
                                          inner_loop, inner_run_plain,
                                          inner_step_plain)
from goicp_tpu_torch.search.transition import _inner_init
from goicp_tpu_torch.utils.npz import savez_exact

INF = float("inf")
_F32 = torch.float32
_I32 = torch.int32

# what the stream loops did since reset_counters(): global iterations,
# transition events, the host reads those two cost, and the pairs sent to
# the deferred phase of capacity escalation
counters = dict(global_iters=0, transitions=0, host_reads=0, escalated=0)


def reset_counters():
    for k in counters:
        counters[k] = 0


class StreamStopped(RuntimeError):
    """A stream (or the compacting batch) stopped at its max_chunks, its
    state checkpointed: the requested stop, and no other error."""


# ---------------------------------------------------------------------------
# nested-state helpers (a state is a dict of tensors; "inner" nests one more)
# ---------------------------------------------------------------------------

def _map_state(fn, *states):
    out = {}
    for k, v in states[0].items():
        rest = [s[k] for s in states[1:]]
        out[k] = _map_state(fn, v, *rest) if isinstance(v, dict) \
            else fn(v, *rest)
    return out


def _row(state: dict, r: int) -> dict:
    return _map_state(lambda x: x[r], state)


def _stack_rows(rows: list) -> dict:
    return _map_state(lambda *xs: torch.stack(xs), *rows)


def _write_row(state: dict, r: int, new: dict):
    """state[...][r] = new[...], in place."""
    for k, v in new.items():
        if isinstance(v, dict):
            _write_row(state[k], r, v)
        else:
            state[k][r] = v


def _pair_row(pair_batch: PairData, r: int) -> PairData:
    return pair_batch.map_tensors(lambda t: t[r])


def _take_pairs(pair_batch: PairData, idx) -> PairData:
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                          device=pair_batch.device)
    return pair_batch.map_tensors(lambda t: t[idx].contiguous())


# ---------------------------------------------------------------------------
# per-pair state
# ---------------------------------------------------------------------------

def _i32(v, dev):
    return torch.tensor(v, dtype=_I32, device=dev)


def fused_init(pair: PairData, cfg: GoICPConfig) -> dict:
    """Initial per-pair state: root rotation frontier + identity/ICP
    incumbent (device_engine.device_init), plus a DUMMY completed inner
    state — the first global iteration transitions it, popping the root
    rotation node and starting the real inner search."""
    dev = pair.device
    Cr = cfg.device_rot_capacity
    L = cfg.rot_batch * 8
    ndp = pair.n_data_padded
    opt_err0, opt_R0, opt_t0, comp0, terms0, better0 = \
        _initial_incumbent(pair, cfg)
    fr_nodes = torch.zeros((Cr, 4), dtype=_F32, device=dev)
    fr_nodes[0] = torch.tensor([cfg.rotMinX, cfg.rotMinY, cfg.rotMinZ,
                                cfg.rotWidth], dtype=_F32, device=dev)
    fr_lbs = torch.full((Cr,), INF, dtype=_F32, device=dev)
    fr_lbs[0] = 0.0
    inner0 = _inner_init(cfg, L, opt_err0)
    inner0["done"] = torch.ones((L,), dtype=torch.bool, device=dev)
    return dict(
        fr_nodes=fr_nodes, fr_lbs=fr_lbs,
        opt_err=opt_err0.to(_F32), opt_R=opt_R0, opt_t=opt_t0,
        comp=comp0.to(_I32), terms=terms0,
        last_icp=better0,
        min_dropped=torch.tensor(INF, dtype=_F32, device=dev),
        it=_i32(0, dev), evals=_i32(0, dev), inner_it=_i32(0, dev),
        icp_runs=_i32(1, dev),
        geom_surv=_i32(0, dev), chem_corners=_i32(0, dev),
        converged=torch.tensor(False, device=dev),
        final_lb=torch.tensor(0.0, dtype=_F32, device=dev),
        # in-flight pop context (filled by each transition)
        inner=inner0,
        pts_rot=torch.zeros((L, ndp, 3), dtype=_F32, device=dev),
        mrd=torch.zeros((L, ndp), dtype=_F32, device=dev),
        widths=torch.zeros((L,), dtype=_F32, device=dev),
        active=torch.zeros((L,), dtype=torch.bool, device=dev),
        child_nodes=torch.zeros((L, 4), dtype=_F32, device=dev),
        R_lanes=torch.eye(3, dtype=_F32, device=dev).expand(L, 3, 3).clone(),
    )


def _init_batch(pair_batch: PairData, cfg: GoICPConfig) -> dict:
    """fused_init for every row of a stacked PairData -> (W, ...) state."""
    W = pair_batch.data.shape[0]
    return _stack_rows([fused_init(_pair_row(pair_batch, r), cfg)
                        for r in range(W)])


# ---------------------------------------------------------------------------
# the inner iteration (batched over the window)
# ---------------------------------------------------------------------------

def _inner_step(pair_batch: PairData, cfg: GoICPConfig, s: dict,
                tables, live: torch.Tensor, bufs=None) -> dict:
    """One inner-BnB iteration for every row where `live` (W,) holds; the
    other rows keep their inner state.  tables: the window's LaneTables
    (the rows' W x L lanes in one step: one launch of the inner step
    kernel on the card), or None for configurations K3/K4 do not carry
    (then row by row, the torch body).  `s` is not written.  bufs: the
    loop's inner.StepBuffers, which the kernel's outputs then come from."""
    ist = s["inner"]
    W, L = ist["done"].shape
    lanes = {k: ist[k] for k in _PER_LANE if k in ist}
    pts = s["pts_rot"].reshape((W * L,) + s["pts_rot"].shape[2:])
    mrd = s["mrd"].reshape(W * L, -1)
    counters = {k: ist[k] for k in ("it", "evals", "geom_surv",
                                    "chem_corners")}
    if tables is not None:
        new, cnt, _ = inner_iteration(tables, cfg, lanes, pts, mrd, True,
                                      live=live, groups=W,
                                      counters=counters, bufs=bufs)
        return dict(new, **cnt)
    outs = []
    for r in range(W):
        outs.append(inner_step_plain(
            _pair_row(pair_batch, r), cfg, {k: v[r] for k, v in lanes.items()},
            s["pts_rot"][r], s["mrd"][r], True, live=live[r:r + 1],
            counters={k: v[r:r + 1] for k, v in counters.items()}))
    out = {k: torch.stack([o[0][k] for o in outs]) for k in lanes}
    out.update({k: torch.cat([o[1][k] for o in outs]) for k in counters})
    return out


def _inner_run(pair_batch: PairData, cfg: GoICPConfig, s: dict, tables,
               mode: str, live=None, watch=None, once=None, steps: int = 0,
               bufs=None):
    """The inner iterations of every row in one run (search/inner.py::
    inner_run): mode "groups" until every row's inner search is complete
    (the batch engine), "stream" the global iterations up to the next
    transition (fused_run_chunk: the rows `live` (W,) says step, until a
    row `watch` marks completes its search or `steps` iterations ran, or
    after one iteration when the 0-d `once` is true).
    tables: as _inner_step's; with None the rows step one by one through
    the torch body.  `s` is not written.  Returns (the new inner state
    with its counters, the iterations run: an int, or a 0-d int32 tensor
    on the card, where the whole run is one launch of csrc/inner.cu).
    bufs: the loop's search/args.py TransitionBuffers, whose two allocations
    the run's outputs then come from in turn (inner.inner_run)."""
    ist = s["inner"]
    W, L = ist["done"].shape
    lanes = {k: ist[k] for k in _PER_LANE if k in ist}
    counters = {k: ist[k] for k in _COUNTERS}
    if tables is not None:
        pts = s["pts_rot"].reshape((W * L,) + s["pts_rot"].shape[2:])
        r = inner_loop(tables, cfg, lanes, pts, s["mrd"].reshape(W * L, -1),
                       True, mode, live=live, watch=watch, once=once,
                       groups=W, counters=counters, steps=steps, bufs=bufs)
    else:
        def step(lanes, live, cnt):
            new = _inner_step(pair_batch, cfg, dict(s, inner=dict(
                lanes, **cnt)), None, live)
            return ({k: new[k] for k in lanes},
                    {k: new[k] for k in _COUNTERS})
        r = inner_run_plain(None, cfg, lanes, None, None, True, mode,
                            live=live, watch=watch, once=once, groups=W,
                            counters=counters, steps=steps, step=step)
    return dict(r.lanes, **r.counters), r.iters


def _inner_complete(cfg: GoICPConfig, s: dict) -> torch.Tensor:
    """(W,) has each pair's in-flight inner search finished?"""
    return torch.all(s["inner"]["done"], dim=-1) \
        | (s["inner"]["it"] >= cfg.inner_max_iters)


# ---------------------------------------------------------------------------
# the outer-step transition (per transitioning row)
# ---------------------------------------------------------------------------

def _transition_tables(pair_batch: PairData, cfg: GoICPConfig):
    """The window's LaneTables for the transition kernel (its epsilon and
    K2's tables), made once per window object and configuration."""
    key = (cfg.mse_margin, bool(cfg.doTrim))
    cache = pair_batch.__dict__.setdefault("_transition_tables", {})
    if key not in cache:
        cache[key] = lane_tables(pair_batch, cfg)
    return cache[key]


def _transition_batch(pair_batch: PairData, cfg: GoICPConfig, s: dict,
                      rows, in_place: bool = False, bufs=None):
    """Outer-step transition of the window rows `rows` (host indices of
    live rows whose inner search completed): one harvest of every row
    (search/transition.py), ONE host read of which of them improved, the
    ICP/compat refine block only for those, then one advance (adopt,
    merge, pop, rotate, fresh inner state) of every row: on the card three
    launches whatever the number of rows, plus one launch refining every
    row that improved.  The adopt ordering is device_engine._make_body's, so
    the per-pair trajectory matches register_device.  in_place: the rows'
    new states are written into `s` (the kernel's own scatter) and None is
    returned; else `s` is left as it was and the rows' new states are
    returned as one state of len(rows) rows, in order (`s` then only
    needs s[k][r] to be row r's value).  bufs: the loop's
    search/args.py TransitionBuffers (the harvest's outputs from its two sets
    in turn, and the calls' argument blocks, re-checked only where the
    window's tensors changed)."""
    counters["transitions"] += 1
    rows = [int(r) for r in rows]
    h = transition.harvest(cfg, s, rows, bufs=bufs)
    if cfg.icp_on_improve:
        do_icp = h["flags"].cpu().numpy()[:, 0]
        counters["host_reads"] += 1
    else:
        do_icp = np.ones(len(rows), bool)
    # the ICP/compat refine block of the rows that improved (improvements
    # are rare): one launch for all of them into the loop's refine record
    r = pick.refine_rows(
        cfg, [(j, _pair_row(pair_batch, rows[j]), s["R_lanes"][rows[j]],
               s["inner"]["best_node"][rows[j]], h["ubs"][j], h["cand_R"][j],
               h["cand_t"][j]) for j in np.nonzero(do_icp)[0]],
        len(rows), pair_batch.device, None if bufs is None else bufs.record)
    new = transition.advance(
        "both", cfg, pair_batch, s, rows,
        tables=_transition_tables(pair_batch, cfg), h=h, r=r,
        out=s if in_place else None, bufs=bufs)
    return None if in_place else new


def _window_tables(pair_batch: PairData, cfg: GoICPConfig, L: int):
    """The window's LaneTables with lane_pair = each row's L lanes, or None
    where K3/K4 do not carry the configuration's chem terms."""
    if _chem_active(cfg) and not only_incomp(cfg):
        return None
    W = pair_batch.data.shape[0]
    lane_pair = torch.arange(W, dtype=_I32, device=pair_batch.device
                             ).repeat_interleave(L)
    return lane_tables(pair_batch, cfg, lane_pair)


def _trans_budget(cfg: GoICPConfig, W: int) -> int:
    return min(cfg.trans_slots, W) if cfg.trans_slots > 0 else W


def fused_run_chunk(pair_batch: PairData, cfg: GoICPConfig, state: dict,
                    steps: int, eager: bool = False) -> dict:
    """Advance the fused window by at most `steps` GLOBAL iterations (each
    one inner-BnB iteration for every in-flight pair + any due outer
    transitions).  Resumable: feed the returned state back in (`state`
    itself is not modified).

    eager=True ALSO returns as soon as any row NEWLY finishes (converged
    or retired at max_outer_steps), so the stream loop refills the row
    immediately instead of leaving it masked until the chunk boundary.
    Pure host pacing — per-pair state math is identical either way.

    cfg.trans_slots = K > 0 serves only the K lowest-index transitioning
    rows per event; the others keep their completed (idempotent) inner
    state and are served at the next one — their own pop sequence is
    unchanged."""
    s = _map_state(torch.clone, state)
    W, L = s["inner"]["done"].shape
    K = _trans_budget(cfg, W)
    tables = _window_tables(pair_batch, cfg, L)
    bufs = TransitionBuffers()
    fin0 = fin0_dev = None
    g = 0
    n = 0          # the global iterations of the last inner run
    while True:
        finished = s["converged"] | (s["it"] >= cfg.max_outer_steps)
        flags = torch.stack([finished, s["converged"],
                             _inner_complete(cfg, s)])
        if isinstance(n, torch.Tensor):
            # the run's iteration count rides in the flags' one copy
            both = torch.cat([flags.reshape(-1).to(_I32),
                              n.reshape(1)]).cpu().numpy()
            flags, n = both[:-1].reshape(3, W) != 0, int(both[-1])
        else:
            flags = flags.cpu().numpy()
        counters["host_reads"] += 1
        g += n
        counters["global_iters"] += n
        if fin0 is None:
            fin0 = flags[0].copy()
            fin0_dev = finished
        go = bool((~flags[0]).any()) and g < steps
        if eager:
            go = go and not bool((flags[0] & ~fin0).any())
        if not go:
            break
        rows = np.nonzero(flags[2] & ~flags[1])[0][:K]
        if len(rows):
            _transition_batch(pair_batch, cfg, s, rows, in_place=True,
                              bufs=bufs)
        # inner iterations for every pair still mid-search (the body is
        # harmless on done inner states; `where` keeps them anyway) up to
        # the next global iteration at which the loop above would act: a
        # transition due, `steps` reached, or (one iteration) every row
        # finished or, eager, a row newly finished; nothing else it reads
        # changes in between
        live = ~s["converged"] & ~_inner_complete(cfg, s)
        fin = s["converged"] | (s["it"] >= cfg.max_outer_steps)
        once = torch.all(fin)
        if eager:
            once = once | torch.any(fin & ~fin0_dev)
        s["inner"], n = _inner_run(pair_batch, cfg, s, tables, "stream",
                                   live=live, watch=~s["converged"],
                                   once=once, steps=steps - g, bufs=bufs)
    return s


# ---------------------------------------------------------------------------
# results, checkpoints
# ---------------------------------------------------------------------------

def _lane_lb(ist: dict) -> torch.Tensor:
    """(..., L) each lane's in-flight lower bound: inner_bnb's lb_safe
    formula (min over thr / min_dropped, plus the remaining frontier min
    for lanes not done)."""
    rem_min = torch.amin(ist["lbs"], dim=-1)
    lane_lb = torch.minimum(ist["thr"], ist["min_dropped"])
    return torch.where(ist["done"], lane_lb, torch.minimum(lane_lb, rem_min))


def _inflight_lb(state: dict) -> torch.Tensor:
    """(W,) lower bound of the popped parents' subtrees still mid-inner-
    search: _lane_lb min-reduced over the active lanes.  A pair retired at
    max_outer_steps removed its popped parents from the rotation frontier
    at the transition, so their subtree's lbs live ONLY here — without
    this fold `remaining` overstates the proven bound."""
    return torch.amin(torch.where(state["active"], _lane_lb(state["inner"]),
                                  INF), dim=-1)


def fused_finalize(state: dict) -> DeviceResult:
    """Batched state -> DeviceResult rows (device_engine.device_finalize
    semantics: remaining/dropped lbs fold into the reported gap; for
    unconverged rows the in-flight inner search's lower bound folds in
    too — see _inflight_lb)."""
    s = state
    remaining = torch.minimum(torch.amin(s["fr_lbs"], dim=-1),
                              s["min_dropped"])
    remaining = torch.minimum(remaining, _inflight_lb(s))
    bound = torch.minimum(torch.where(s["converged"], s["final_lb"],
                                      remaining), s["opt_err"])
    gap = torch.clamp(s["opt_err"] - bound, min=0.0)
    return DeviceResult(error=s["opt_err"], R=s["opt_R"], t=s["opt_t"],
                        opt_comp=s["comp"], terms=s["terms"],
                        last_icp=s["last_icp"], outer_iters=s["it"],
                        evals=s["evals"], gap=gap,
                        converged=s["converged"],
                        inner_iters=s["inner_it"],
                        icp_runs=s["icp_runs"],
                        geom_surv=s["geom_surv"] + s["inner"]["geom_surv"],
                        chem_corners=s["chem_corners"]
                        + s["inner"]["chem_corners"])


def _flat_items(state: dict):
    for k, v in state.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                yield f"{k}.{k2}", v2
        else:
            yield k, v


def _flatten_state(state: dict) -> dict:
    """Nested state -> flat dict of numpy arrays with dotted keys."""
    return {k: np.asarray(v.cpu()) for k, v in _flat_items(state)}


def _unflatten_state(blob: dict, device) -> dict:
    state: dict = {}
    for k, v in blob.items():
        t = torch.as_tensor(np.array(np.asarray(v)), device=device)
        if "." in k:
            k1, k2 = k.split(".", 1)
            state.setdefault(k1, {})[k2] = t
        else:
            state[k] = t
    return state


def stream_state_from_jax(state: dict, device=None) -> dict:
    """A stream state of the JAX package (nested dict of arrays, as its
    fused_init / fused_run_chunk return it) -> the port's state on
    `device` (None: goicp_tpu_torch.default_device()), leaf by leaf with
    the dtypes kept.  Duck-typed: nothing of JAX is imported here."""
    if device is None:
        from goicp_tpu_torch import default_device
        device = default_device()
    return _unflatten_state(dict(_flat_items(state)), device)


def save_stream_state(path: str, state: dict, rows_orig, dead, next_pair,
                      done: dict) -> None:
    """Checkpoint an in-flight stream: per-row search state (nested dicts
    flattened to dotted keys, dtypes kept), window bookkeeping, retired
    results."""
    blob = {f"state_{k}": v for k, v in _flatten_state(state).items()}
    blob["rows_orig"] = np.asarray(rows_orig, np.int64)
    blob["dead"] = np.asarray(dead, bool)
    blob["next_pair"] = np.int64(next_pair)
    blob["done_idx"] = np.asarray(sorted(done.keys()), np.int64)
    for f in DeviceResult._fields:
        blob[f"done_{f}"] = np.stack(
            [np.asarray(getattr(done[i], f))
             for i in sorted(done.keys())]) if done else np.zeros((0,))
    savez_exact(path, blob)


def load_stream_state(path: str, device=None):
    """-> (state on `device`, rows_orig, dead, next_pair, done); device
    None means goicp_tpu_torch.default_device()."""
    if device is None:
        from goicp_tpu_torch import default_device
        device = default_device()
    with np.load(path) as z:
        state = _unflatten_state(
            {k[len("state_"):]: z[k] for k in z.files
             if k.startswith("state_")}, device)
        rows_orig = [int(i) for i in z["rows_orig"]]
        dead = [bool(d) for d in z["dead"]]
        next_pair = int(z["next_pair"])
        done = {}
        for j, i in enumerate(z["done_idx"]):
            done[int(i)] = DeviceResult(
                *(z[f"done_{f}"][j] for f in DeviceResult._fields))
    return state, rows_orig, dead, next_pair, done


def migrate_row_capacity(row_state: dict, cfg: GoICPConfig,
                         cfg2: GoICPConfig) -> dict:
    """Pad one row's in-flight translation frontiers from
    cfg.trans_capacity to cfg2.trans_capacity (>=).  Lossless: the new
    slots are empty (lb INF, node and corner payload 0), so the sorted-
    frontier invariant and every bound hold, and the search continues as
    if the wider frontier had never been filled past the old capacity.
    Everything else in the row state does not depend on the capacity."""
    C1, C2 = cfg.trans_capacity, cfg2.trans_capacity
    if C2 < C1:
        raise ValueError("migrate_row_capacity can only widen the frontier")
    if (cfg2.trans_pop, cfg2.rot_batch, cfg2.device_rot_capacity) != \
            (cfg.trans_pop, cfg.rot_batch, cfg.device_rot_capacity):
        raise ValueError("migrate_row_capacity changes trans_capacity only")
    pad = C2 - C1
    if pad == 0:
        return row_state
    ist = dict(row_state["inner"])
    ist["nodes"] = torch.nn.functional.pad(ist["nodes"], (0, 0, 0, pad))
    ist["lbs"] = torch.nn.functional.pad(ist["lbs"], (0, pad), value=INF)
    if "cvals" in ist:
        ist["cvals"] = torch.nn.functional.pad(ist["cvals"], (0, 0, 0, pad))
    return dict(row_state, inner=ist)


def straggler_to_lane_sharded(pair, cfg: GoICPConfig, row_state: dict,
                              mesh) -> DeviceResult:
    """Hand a lone in-flight straggler of a drained fused window to
    rotation-lane sharding over `mesh`'s `search` axis: once the window
    drains, pair-level data parallelism leaves every other rank idle, and
    the straggler's own lanes are the parallelism left.  Every rank of the
    mesh calls this with the same pair and row state.

    The row's in-flight pop (parents popped, their children mid-inner-
    search, no longer in fr_lbs) is re-inserted as its children with their
    CURRENT in-flight lower bounds (_lane_lb: valid bounds for each child's
    subtree), giving a pure rotation-frontier state that register_device's
    lane-sharded steps (device_run_chunk(mesh=)) run to convergence.  The
    partial inner progress of those lanes is searched again when the
    children pop again: bounded rework, epsilon-optimality untouched."""
    from goicp_tpu_torch.search.device_engine import (device_finalize,
                                                      device_run_chunk)
    ist = row_state["inner"]
    lane_lb = _lane_lb(ist)
    lbs_new = torch.where(row_state["active"]
                          & (lane_lb < row_state["opt_err"]), lane_lb, INF)
    Cr = cfg.device_rot_capacity
    all_lbs = torch.cat([row_state["fr_lbs"], lbs_new])
    all_nodes = torch.cat([row_state["fr_nodes"], row_state["child_nodes"]])
    order = torch.argsort(all_lbs, stable=True)
    dropped = all_lbs[order[Cr:]]
    min_drop = torch.amin(torch.where(torch.isfinite(dropped), dropped, INF))
    dstate = {k: row_state[k] for k in (
        "opt_err", "opt_R", "opt_t", "comp", "terms", "last_icp", "it",
        "evals", "inner_it", "icp_runs", "converged", "final_lb")}
    dstate.update(
        fr_nodes=all_nodes[order[:Cr]], fr_lbs=all_lbs[order[:Cr]],
        min_dropped=torch.minimum(row_state["min_dropped"], min_drop),
        geom_surv=row_state["geom_surv"] + ist["geom_surv"],
        chem_corners=row_state["chem_corners"] + ist["chem_corners"])
    while not bool(dstate["converged"]) \
            and int(dstate["it"]) < cfg.max_outer_steps:
        dstate = device_run_chunk(pair, cfg, dstate, 512, mesh=mesh)
    return device_finalize(dstate)


def _fused_inflight_np(state: dict) -> np.ndarray:
    """(W,) in-flight inner lower bound, on the host (progress telemetry)."""
    return np.asarray(_inflight_lb(state).cpu())


# ---------------------------------------------------------------------------
# the stream host loop
# ---------------------------------------------------------------------------

def register_fused_stream(pairs, cfg: GoICPConfig, width: int = 8,
                          chunk_steps: int = 256,
                          progress=None,
                          checkpoint_path: str | None = None,
                          resume: bool = False,
                          max_chunks: int | None = None,
                          mesh=None, checkpoint_every: int = 1,
                          eager: bool = False,
                          escalate_capacity: int | None = None,
                          escalate_after_chunks: int = 8):
    """Continuous-batching registration over the fused engine: a window of
    `width` pairs advances in chunks of `chunk_steps` GLOBAL iterations;
    converged pairs retire at chunk boundaries and fresh pairs refill
    their rows.  Runs on the device of the pairs it is given (all on one
    device, one shape bucket, count-dynamic).

    progress: optional callable(dict) invoked at each chunk boundary with
    in-flight telemetry (the analogue of the reference's periodic
    LB/level/elapsed prints, jly_goicp.cpp:694-700).

    checkpoint_path: save the in-flight window state after every chunk;
    resume=True restarts from that file (same pairs, cfg) and converges to
    the identical results (the search is deterministic).  The file is
    written at exactly checkpoint_path, whatever its suffix.  max_chunks
    bounds the chunks executed (kill/restart): when hit, the state is
    saved and StreamStopped (a RuntimeError) raised.

    eager: end a chunk early when a row newly finishes so it refills
    immediately (see fused_run_chunk) — pure host pacing, identical
    per-pair results.

    escalate_capacity: frontier-capacity escalation for eval-heavy
    stragglers.  A row still in flight after escalate_after_chunks chunks
    leaves the window (its state migrated without loss to trans_capacity=
    escalate_capacity, see migrate_row_capacity), its row refills with a
    fresh pair, and the evicted pairs finish in a deferred phase, two at a
    time, at the deeper capacity.  Results stay epsilon-optimal (each
    pair's gap carries the same folded bounds); an escalated pair's
    trajectory differs from the plain run's only after its migration.
    escalate_capacity must exceed cfg.trans_capacity, and checkpoints are
    not supported with it (the deferred pairs are not checkpointed): both
    raise ValueError.

    mesh (dist/mesh.Mesh): every rank of it calls this with the same
    pairs.  The window's rows split over the `data` axis (the width
    rounded up to a multiple of its size, with dead rows that never
    search); when the mesh also has a `search` axis of more than one rank,
    a lone straggler left after the window drains goes to rotation-lane
    sharding over that axis (straggler_to_lane_sharded) instead of leaving
    the other ranks idle.  Every rank returns every pair's result; with
    checkpoint_path each rank saves its block to a file of its own
    (dist/mesh.rank_path).  Escalation and mesh together raise ValueError.

    Returns DeviceResult of numpy arrays, batch axis in pair order."""
    escalate = None
    if escalate_capacity is not None:
        if escalate_capacity <= cfg.trans_capacity:
            raise ValueError(
                f"escalate_capacity={escalate_capacity} must exceed "
                f"trans_capacity={cfg.trans_capacity}")
        if checkpoint_path is not None:
            raise ValueError("escalate_capacity is incompatible with "
                             "checkpoint_path")
        if mesh is not None:
            raise ValueError("escalate_capacity is incompatible with mesh")
        cfg2 = dataclasses.replace(cfg, trans_capacity=escalate_capacity)

        def run_hard(hard, stacked_all):
            """[(original pair, row state)] -> {original pair:
            DeviceResult}: the deferred phase, the migrated rows two at a
            time run to convergence at the deeper capacity (an odd last
            row runs alone)."""
            out = {}
            for lo in range(0, len(hard), 2):
                group = hard[lo:lo + 2]
                idxs = [i for i, _ in group]
                state2 = _stack_rows([migrate_row_capacity(rs, cfg, cfg2)
                                      for _, rs in group])
                pair_b = _take_pairs(stacked_all, idxs)
                while True:
                    state2 = fused_run_chunk(pair_b, cfg2, state2,
                                             chunk_steps, eager=eager)
                    fini = torch.stack([
                        state2["converged"],
                        state2["it"] >= cfg.max_outer_steps]).cpu().numpy()
                    if (fini[0] | fini[1]).all():
                        break
                for j, row in enumerate(_result_rows(fused_finalize(state2))):
                    out[idxs[j]] = row
            return out

        escalate = (escalate_after_chunks, run_hard)

    def run_chunk(pair_batch, cfg_, state, steps):
        return fused_run_chunk(pair_batch, cfg_, state, steps, eager=eager)

    straggler_fn = None
    if mesh is not None and mesh.n_search > 1:
        def straggler_fn(pair1, row_state):
            return straggler_to_lane_sharded(pair1, cfg, row_state, mesh)

    return _stream_driver(pairs, cfg, width=width, chunk_steps=chunk_steps,
                          progress=progress,
                          checkpoint_path=checkpoint_path, resume=resume,
                          max_chunks=max_chunks,
                          init_fn=_init_batch, run_chunk=run_chunk,
                          finalize=fused_finalize,
                          inflight_fn=_fused_inflight_np,
                          checkpoint_every=checkpoint_every,
                          escalate=escalate, mesh=mesh,
                          straggler_fn=straggler_fn)


def _result_rows(res: DeviceResult) -> list:
    """Batched DeviceResult of tensors -> one DeviceResult of numpy values
    per row."""
    cols = [np.asarray(getattr(res, f).cpu()) for f in DeviceResult._fields]
    return [DeviceResult(*(c[r] for c in cols)) for r in range(len(cols[0]))]


def _stream_driver(pairs, cfg: GoICPConfig, width, chunk_steps, progress,
                   checkpoint_path, resume, max_chunks,
                   init_fn, run_chunk, finalize, inflight_fn=None,
                   checkpoint_every: int = 1, escalate=None, mesh=None,
                   straggler_fn=None):
    """Engine-generic continuous-batching host loop (window refill,
    checkpoint/resume, progress) shared by the fused and packed streams.
    init_fn(pair_batch, cfg) -> state; run_chunk(pair_batch, cfg, state,
    steps) -> state; finalize(state) -> DeviceResult batch.

    checkpoint_every: chunks between on-disk state saves (each save copies
    the whole window state to the host).  The state is ALWAYS saved before
    a max_chunks abort.

    escalate: (after_chunks, run_hard) or None.  A row alive after
    after_chunks chunks is harvested into a list and its row refilled; at
    the end run_hard(list, stacked pairs) finishes the list's pairs and
    returns their results (register_fused_stream's escalate_capacity).

    mesh: this rank holds the window rows [lo, lo + width / n_data) (its
    `data` block) in `state`; the window's bookkeeping (rows_orig, dead,
    next_pair, done) is replicated, kept the same on every rank by reading
    only all-gathered flags and results.  straggler_fn(pair, row state):
    finishes the last live pair once no refill remains (see
    register_fused_stream)."""
    B = len(pairs)
    n_data = 1 if mesh is None else mesh.n_data
    # dead rows (pair 0, pre-converged, never reported) keep the width a
    # multiple of the data axis even when fewer pairs than ranks remain
    width = -(-min(width, B) // n_data) * n_data
    w_loc = width // n_data
    lo = 0 if mesh is None else mesh.data_rank * w_loc
    local = range(lo, lo + w_loc)
    stacked_all = stack_pairs(list(pairs))
    dev = stacked_all.device
    if mesh is not None and checkpoint_path:
        from goicp_tpu_torch.dist.mesh import rank_path
        checkpoint_path = rank_path(checkpoint_path)

    def gather(t: torch.Tensor) -> torch.Tensor:
        """This rank's rows -> the window's, on every rank."""
        return t if mesh is None else mesh.all_gather(t, "data").flatten(0, 1)

    def window_rows(state) -> list:
        res = finalize(state)
        return _result_rows(type(res)(*(gather(v) for v in res)))

    def window_pairs() -> PairData:
        return _take_pairs(stacked_all, [0 if dead[r] else rows_orig[r]
                                         for r in local])

    def fresh_window(cur_pair) -> dict:
        state = init_fn(cur_pair, cfg)
        for r in local:
            if dead[r]:
                state["converged"][r - lo] = True
        return state

    n0 = min(width, B)
    rows_orig = [i if i < n0 else 0 for i in range(width)]
    next_pair = n0
    done: dict[int, DeviceResult] = {}
    dead = [i >= n0 for i in range(width)]
    # capacity escalation: chunks each row has lived, and the rows
    # harvested for the deferred phase
    row_age = [0] * width
    hard: list = []

    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state, rows_orig, dead, next_pair, done = \
            load_stream_state(checkpoint_path, dev)
        cur_pair = window_pairs()
    else:
        cur_pair = window_pairs()
        state = fresh_window(cur_pair)

    chunks = 0
    while True:
        state = run_chunk(cur_pair, cfg, state, chunk_steps)
        chunks += 1
        flags = gather(torch.stack([state["converged"].to(torch.int64),
                                    state["it"].to(torch.int64)], dim=1))
        flags = flags.cpu().numpy()
        conv = flags[:, 0] > 0
        its = flags[:, 1]
        finished = conv | (its >= cfg.max_outer_steps)

        evicted: list[int] = []
        if escalate is not None:
            for r in range(width):
                if dead[r] or finished[r]:
                    continue
                row_age[r] += 1
                if row_age[r] >= escalate[0]:
                    # harvest the row BEFORE a refill writes over it
                    hard.append((rows_orig[r],
                                 _map_state(torch.clone, _row(state, r))))
                    evicted.append(r)
                    counters["escalated"] += 1

        # the straggler handoff: the window has drained to ONE live pair
        # and no refill remains; its state, gathered from the rank that
        # holds it, goes to rotation-lane sharding on every rank
        if straggler_fn is not None and next_pair >= B:
            live = [r for r in range(width) if not (finished[r] or dead[r])]
            if len(live) == 1:
                r = live[0]
                row = _map_state(lambda x: mesh.all_gather(
                    x[r % w_loc], "data")[r // w_loc], state)
                done[rows_orig[r]] = result_to_numpy(straggler_fn(
                    _pair_row(stacked_all, rows_orig[r]), row))
                dead[r] = True
                finished[:] = True                 # the window is served

        if progress is not None:
            # frontier_min folds the in-flight inner search's bound (the
            # popped parents' subtrees are no longer in fr_lbs)
            infl = inflight_fn(state) if inflight_fn is not None \
                else np.full(w_loc, np.inf)
            rows = gather(torch.stack([
                state["opt_err"], state["fr_lbs"][:, 0],
                torch.as_tensor(infl, dtype=_F32, device=dev)], dim=1))
            rows = rows.cpu().numpy()
            progress(dict(
                chunk=chunks,
                rows=[{"pair": rows_orig[r], "dead": dead[r],
                       "converged": bool(conv[r]),
                       "outer": int(its[r]),
                       "incumbent": float(rows[r, 0]),
                       "frontier_min": float(min(rows[r, 1], rows[r, 2]))}
                      for r in range(width)]))

        if all(finished[r] or dead[r] for r in range(width)):
            res = window_rows(state)
            for r in range(width):
                if not dead[r] and rows_orig[r] not in done:
                    done[rows_orig[r]] = res[r]
            if next_pair >= B:
                break
            n = min(width, B - next_pair)
            rows_orig = [next_pair + i if i < n else 0 for i in range(width)]
            dead = [i >= n for i in range(width)]
            row_age = [0] * width
            next_pair += n
            cur_pair = window_pairs()
            state = fresh_window(cur_pair)
        else:
            retired = [r for r in range(width)
                       if (finished[r] or r in evicted) and not dead[r]]
            if retired:
                need_res = [r for r in retired if r not in evicted]
                res = window_rows(state) if need_res else None
                for r in retired:
                    if r not in evicted and rows_orig[r] not in done:
                        done[rows_orig[r]] = res[r]
                    row_age[r] = 0
                    if next_pair < B:
                        if r in local:
                            sub_pair = _take_pairs(stacked_all, [next_pair])
                            _write_row(state, r - lo,
                                       _row(init_fn(sub_pair, cfg), 0))
                        rows_orig[r] = next_pair
                        next_pair += 1
                    else:
                        dead[r] = True
                        if r in evicted:
                            # no refill left: stop advancing the evicted
                            # row's stale state
                            state["converged"][r - lo] = True
                cur_pair = window_pairs()

        # the tail runs on EVERY path (incl. a whole-window retire+refill):
        # the on-disk checkpoint never lags the in-memory state by more
        # than checkpoint_every chunks, and max_chunks cannot overshoot
        hit_cap = max_chunks is not None and chunks >= max_chunks
        if checkpoint_path and (chunks % max(checkpoint_every, 1) == 0
                                or hit_cap):
            save_stream_state(checkpoint_path, state, rows_orig, dead,
                              next_pair, done)
        if hit_cap:
            raise StreamStopped(
                f"max_chunks={max_chunks} reached with "
                f"{B - len(done)} pairs unfinished (state checkpointed)")

    if hard:
        # the deferred phase: evicted pairs finish at the deeper capacity
        done.update(escalate[1](hard, stacked_all))
    rows = [done[i] for i in range(B)]
    out = DeviceResult(*(np.stack([np.asarray(getattr(r, f)) for r in rows])
                         for f in DeviceResult._fields))
    if np.isnan(np.asarray(out.error)).any():
        # numeric guard: engines make NaN scores infectious so they
        # surface loudly here rather than being silently ignored
        bad = np.where(np.isnan(np.asarray(out.error)))[0].tolist()
        raise FloatingPointError(
            f"NaN escaped bound/ICP scoring for pair rows {bad}")
    return out
