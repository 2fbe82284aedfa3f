"""Device-side Go-ICP registration: one pair, or a batch of pairs.

Port of goicp_tpu/search/device_engine.py (`register_device`,
`device_run_chunk`, `register_device_batch`).  The
rotation frontier is a fixed-capacity tensor on the device; one
outer step pops the rot_batch lowest-lb rotation cubes, expands 8 children
each, runs the fused lane-batched inner translation BnB on every child
lane, ICP-refines the best candidates, adopts, prunes and merges the
children back with one stable sort.

Epsilon-optimality mirrors search/inner.py: rotation nodes are only
discarded when lb >= incumbent or lb > incumbent - SSEThresh (the
reference's own termination rule, jly_goicp.cpp:685), and capacity
overflows fold the minimum dropped lb into the reported gap.

The JAX package runs the outer loop as one lax.while_loop; here it is a
Python loop that reads the host once per outer step (the harvest's
flags: improved, converged); the inner search is one launch of the inner
run on the card (search/inner.py::inner_run), no host read.  The pop, the harvest and the adoption are
search/transition.py's (on the card csrc/transition.cu); the ICP, its
rescoring and the BnB compat count run only on a step whose candidate
improved (every step with icp_on_improve=0), written into the run's
refine record by search/pick.py (on the card one launch of the refine
route, csrc/icp.cu: the seeds, the ICP event and the pick; no host
read).

With a mesh (dist/mesh.py), register_device splits each outer step's
rotation lanes over the mesh's `search` axis: every search rank runs the
inner search on its L/n lanes, the per-lane results are all-gathered, and
the cross-lane reductions (argmin, ICP seeds, adopt, merge) run replicated,
so the predicate every rank reads is the same.  register_device_batch
splits the pair axis over `data`.

The JAX package batches pairs by vmapping that loop.  Here a batch state
is the one-pair state with a leading row axis, and one batched outer step
pops and expands every unconverged row (one transition call), runs the
inner searches of all rows as one lane batch (the fused stream's inner
step, search/fused_stream.py), then harvests and adopts every row (one
call each), refining only the rows that improved.  Each row's trajectory
is its own register_device's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.bounds.evaluate import one_pair_tables
from goicp_tpu_torch.bounds.error import rescore
from goicp_tpu_torch.icp.icp import icp_run
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.search import pick, transition
from goicp_tpu_torch.search.pick import INIT_SEED_RV as _INIT_SEED_RV
from goicp_tpu_torch.search.args import TransitionBuffers
from goicp_tpu_torch.search.inner import InnerResult, inner_bnb

INF = float("inf")


class DeviceResult(NamedTuple):
    error: torch.Tensor        # scalar
    R: torch.Tensor            # (3,3)
    t: torch.Tensor            # (3,)
    opt_comp: torch.Tensor     # incompatibility count at the optimum
    terms: torch.Tensor        # (3,) [geom, incomp(+nbr), fpfh]
    last_icp: torch.Tensor     # bool
    outer_iters: int
    evals: torch.Tensor
    gap: torch.Tensor          # epsilon bound on suboptimality
    converged: torch.Tensor    # bool
    inner_iters: torch.Tensor  # total sequential inner-BnB iterations
    icp_runs: torch.Tensor     # ICP invocation events (initial + improving)
    geom_surv: torch.Tensor = 0
    chem_corners: torch.Tensor = 0


def _icp_from(pair: PairData, cfg: GoICPConfig, R0, t0, enabled=None):
    """ICP from K starts, each scored: (R, t, Score, icp_incomp), batched
    (on the card one launch of csrc/icp.cu and one of csrc/score.cu)."""
    r = icp_run(pair.data, pair.model, R0, t0, **pick.icp_kw(pair, cfg),
                enabled=enabled)
    sc, inc = rescore(pair, cfg, r.R, r.t, r.nn_idx)
    return r.R, r.t, sc, inc


def _initial_incumbent(pair: PairData, cfg: GoICPConfig):
    """Initial incumbent: identity error + chem worst-case seeds, then ICP
    from identity (and, with cfg.init_seeds > 1, from K-1 coarse rotations
    too, adopting the best): search/pick.py's initial_incumbent, on the
    card one launch of csrc/icp.cu's initial route and no host read.
    Returns (opt_err0, opt_R0, opt_t0, comp0, terms0, better0)."""
    o = pick.initial_incumbent(pair, cfg)
    return (o["opt_err"], o["opt_R"], o["opt_t"], o["comp"], o["terms"],
            o["last_icp"])


def device_init(pair: PairData, cfg: GoICPConfig) -> dict:
    """Initial search state: root rotation frontier + identity/ICP
    incumbent."""
    dev = pair.device
    Cr = cfg.device_rot_capacity
    opt_err0, opt_R0, opt_t0, comp0, terms0, better0 = \
        _initial_incumbent(pair, cfg)
    root = torch.tensor([cfg.rotMinX, cfg.rotMinY, cfg.rotMinZ,
                         cfg.rotWidth], dtype=torch.float32, device=dev)
    fr_nodes0 = torch.zeros((Cr, 4), dtype=torch.float32, device=dev)
    fr_nodes0[0] = root
    fr_lbs0 = torch.full((Cr,), INF, dtype=torch.float32, device=dev)
    fr_lbs0[0] = 0.0

    def i32(v=0):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return dict(
        fr_nodes=fr_nodes0, fr_lbs=fr_lbs0,
        opt_err=opt_err0, opt_R=opt_R0, opt_t=opt_t0,
        comp=comp0, terms=terms0,
        last_icp=better0,
        min_dropped=torch.tensor(INF, dtype=torch.float32, device=dev),
        it=0, evals=i32(), inner_it=i32(), icp_runs=i32(1),
        converged=torch.tensor(False, device=dev),
        final_lb=torch.tensor(0.0, dtype=torch.float32, device=dev),
        geom_surv=i32(), chem_corners=i32(),
    )


def _one_row(pair: PairData, cfg: GoICPConfig):
    """(the pair as a 1-row batch, its LaneTables): views made once per
    pair and configuration and kept on the pair, so that an outer step's
    transition calls cost no launch to set up."""
    key = (cfg.mse_margin, bool(cfg.doTrim))
    cache = pair.__dict__.setdefault("_transition_rows", {})
    if key not in cache:
        cache[key] = (pair.map_tensors(lambda t: t[None]),
                      one_pair_tables(pair, cfg))
    return cache[key]


def _as_row(s: dict) -> dict:
    """One pair's state as a 1-row batch state (views)."""
    return {k: v[None] if isinstance(v, torch.Tensor) else v
            for k, v in s.items()}


def _pop(pair: PairData, cfg: GoICPConfig, s: dict, min_lb=None,
         bufs=None) -> dict:
    """The head of an outer step (search/transition.py, advance in pop
    mode): pop the rot_batch lowest-lb rotation nodes (sorted frontier),
    test convergence, expand 8 children each with the pi-ball filter,
    rotate the data for every child lane, its rotation uncertainty (mrd)
    and the inner search's fresh lanes (`lanes`).  min_lb: the lb
    convergence is tested on (None: the frontier's own minimum; the
    sharded engine passes the minimum over every rank's frontier).  Also
    the rest of the frontier (fr_lbs, fr_nodes: views of s's).  bufs: the
    run's search/args.py TransitionBuffers, whose two sets the pop's outputs
    come from in turn."""
    pb, tabs = _one_row(pair, cfg)
    p = transition.advance("pop", cfg, pb, _as_row(s), [0], tables=tabs,
                           min_lb=None if min_lb is None
                           else min_lb.reshape(1), bufs=bufs)
    out = {k: v[0] for k, v in p.items() if k != "lanes"}
    out.update(lanes={k: v[0] for k, v in p["lanes"].items()},
               fr_lbs=s["fr_lbs"][cfg.rot_batch:],
               fr_nodes=s["fr_nodes"][cfg.rot_batch:], batch=p)
    return out


def _work(res_ub, res_lb, fused: bool) -> dict:
    """The inner search's counters an outer step adds."""
    if fused:
        return dict(evals=res_ub.evals, iters=res_ub.iters,
                    geom_surv=res_ub.geom_surv,
                    chem_corners=res_ub.chem_corners)
    return dict(evals=res_ub.evals + res_lb.evals,
                iters=res_ub.iters + res_lb.iters,
                geom_surv=res_ub.geom_surv + res_lb.geom_surv,
                chem_corners=res_ub.chem_corners + res_lb.chem_corners)


def _harvest_src(p: dict, opt_err, res_ub: InnerResult) -> dict:
    """What the transition's harvest reads of one pair's outer step, as a
    1-row batch: the ub pass's lanes, the pop's active lanes and R."""
    return dict(inner={"opt_err": res_ub.best_err[None],
                       "best_node": res_ub.best_node[None],
                       "ub_terms": res_ub.ub_terms[None]},
                active=p["batch"]["active"], R_lanes=p["batch"]["R_lanes"],
                opt_err=opt_err.reshape(1))


def _lb_lanes(lanes: dict | None) -> dict | None:
    """An inner search's final lanes as a 1-row batch (None: gathered over
    a mesh, lb_safe given instead)."""
    return None if lanes is None else {k: v[None] for k, v in lanes.items()}


def _make_body(pair: PairData, cfg: GoICPConfig, mesh=None):
    """One outer BnB step: pop -> expand -> inner search -> ICP -> adopt ->
    prune/merge, body(s) -> (new state, converged on the host).  The pop,
    the harvest and the adoption are search/transition.py's (on the card
    csrc/transition.cu: three launches, their outputs from the run's two
    sets in turn, the states alternating between the adoption's two: a
    state the body returned is valid until the step after next); the
    step reads the host ONCE, the
    harvest's flags (improved, converged), and runs the ICP, its rescoring
    and the BnB compat count only when the candidate improved (always with
    icp_on_improve=0), never for a converged step, whose result is frozen.
    With a mesh the inner search runs on this rank's block of the lanes
    (its kernels device-local) and its results are all-gathered over
    `search` (dist/mesh.gather_lanes); every rank runs the same transition
    calls on the same replicated values."""
    pb, tabs = _one_row(pair, cfg)
    L = cfg.rot_batch * 8
    # the run's transition and inner-run outputs, two sets used in turn,
    # and its argument blocks
    bufs = TransitionBuffers()

    def inner(p, inc, with_rot_uncertainty, fused, lanes0, mrd):
        """(InnerResult, its final lanes; None over a mesh: lb_safe
        gathered instead)."""
        pts, widths, active = p["pts"], p["widths"], p["active"]
        if mesh is None:
            return inner_bnb(pair, cfg, pts, widths, active, inc,
                             with_rot_uncertainty=with_rot_uncertainty,
                             fused=fused, lanes0=lanes0, mrd=mrd, raw=True,
                             bufs=bufs)
        from goicp_tpu_torch.dist.mesh import gather_lanes
        mine = mesh.block(L, "search")
        return gather_lanes(inner_bnb(
            pair, cfg, pts[mine], widths[mine], active[mine], inc,
            with_rot_uncertainty=with_rot_uncertainty, fused=fused,
            lanes0={k: v[mine] for k, v in lanes0.items()},
            mrd=None if mrd is None else mrd[mine]), mesh), None

    def body(s):
        p = _pop(pair, cfg, s, bufs=bufs)
        conv = p["batch"]["converged"]
        if cfg.fused_inner:
            res_ub, lanes = inner(p, s["opt_err"], False, True, p["lanes"],
                                  p["mrd"])
            res_lb = res_ub
        else:
            res_ub, lanes = inner(p, s["opt_err"], False, False,
                                  p["lanes"], None)
            h1 = transition.harvest(cfg, _harvest_src(p, s["opt_err"],
                                                      res_ub), [0],
                                    fused=False, lb=_lb_lanes(lanes),
                                    bufs=bufs)
            # the lb pass starts from the same root at the candidate's
            # incumbent
            inc = torch.ones((L,), dtype=torch.float32,
                             device=pair.device) * h1["incumbent"][0]
            res_lb, lanes = inner(p, h1["incumbent"][0], True, False,
                                  dict(p["lanes"], opt_err=inc,
                                       thr=inc.clone()), p["mrd"])
        lb = _lb_lanes(lanes)
        h = transition.harvest(
            cfg, _harvest_src(p, s["opt_err"], res_ub), [0],
            fused=bool(cfg.fused_inner), lb=lb, conv=conv,
            lb_safe=None if lb is not None else res_lb.lb_safe[None],
            bufs=bufs)
        flags = h["flags"].cpu().numpy()[0]          # the one host read
        improved, converged = bool(flags[0]), bool(flags[1])
        # ICP gating (refine only on improvement, jly_goicp.cpp:771-854):
        # the ICP seeds, the event, the pick of the best seed and the
        # candidate's count written into the run's refine record (one
        # launch, no host read)
        r = pick.refine_rows(
            cfg, [(0, pair, p["R_lanes"], res_ub.best_node, h["ubs"][0],
                   h["cand_R"][0], h["cand_t"][0])]
            if (improved or not cfg.icp_on_improve) and not converged
            else [], 1, pair.device, bufs.record)
        new = transition.advance(
            "adopt", cfg, pb, _as_row(s), [0], tables=tabs, h=h, r=r,
            p=p["batch"], work=_work(res_ub, res_lb, cfg.fused_inner),
            bufs=bufs)
        new = {k: v[0] for k, v in new.items()}
        new["it"] = s["it"] + 1
        return new, converged

    return body


def device_finalize(state: dict) -> DeviceResult:
    """Search state -> DeviceResult (gap folds capacity-dropped lbs).  A
    batch state (leading row axis) gives a DeviceResult of batches."""
    s = state
    remaining = torch.minimum(torch.amin(s["fr_lbs"], dim=-1),
                              s["min_dropped"])
    bound = torch.minimum(torch.where(s["converged"], s["final_lb"],
                                      remaining), s["opt_err"])
    # when capacity dropped nodes below the incumbent, the true gap may
    # exceed sse; report it honestly
    gap = torch.clamp(s["opt_err"] - bound, min=0.0)
    return DeviceResult(error=s["opt_err"], R=s["opt_R"], t=s["opt_t"],
                        opt_comp=s["comp"], terms=s["terms"],
                        last_icp=s["last_icp"], outer_iters=s["it"],
                        evals=s["evals"], gap=gap,
                        converged=s["converged"],
                        inner_iters=s["inner_it"],
                        icp_runs=s["icp_runs"],
                        geom_surv=s["geom_surv"],
                        chem_corners=s["chem_corners"])


def device_run_chunk(pair: PairData, cfg: GoICPConfig, state: dict,
                     steps: int, mesh=None) -> dict:
    """Advance one pair's search by at most `steps` outer iterations
    (resumable: feed the returned state back in; device_finalize when
    converged).  `state` itself is not modified.  mesh: split the lanes
    over its `search` axis (see register_device); every rank of the mesh
    calls this with the same pair and state."""
    if mesh is not None and not cfg.fused_inner:
        raise ValueError("lane sharding (mesh=...) requires fused_inner=1 "
                         "(the two-pass inner path runs unsharded)")
    s = dict(state)
    it = int(s["it"])
    limit = min(it + int(steps), cfg.max_outer_steps)
    body = _make_body(pair, cfg, mesh)
    converged = bool(s["converged"])
    while it < limit and not converged:
        s, converged = body(s)
        it += 1
    return s


def register_device(pair: PairData, cfg: GoICPConfig,
                    mesh=None) -> DeviceResult:
    """The whole Go-ICP search for one pair, on the pair's device.  mesh
    (dist/mesh.Mesh): every rank of it calls this with the same pair; the
    rotation lanes of each outer step split over its `search` axis, whose
    size must divide rot_batch * 8, and every rank returns the result.
    The counters are the unsharded run's (evals summed over the ranks,
    inner iterations the slowest rank's) except chem_corners, which counts
    the corners evaluated: with lane compaction it depends on the lane block
    each rank searches."""
    return device_finalize(device_run_chunk(pair, cfg, device_init(pair, cfg),
                                            cfg.max_outer_steps, mesh=mesh))


# ---------------------------------------------------------------------------
# B pairs of one shape bucket at once
# ---------------------------------------------------------------------------

def batch_init(pair_batch: PairData, cfg: GoICPConfig) -> dict:
    """device_init for every row of a stacked PairData (dist/mesh.
    stack_pairs) -> the batch state: the same dict with a leading row
    axis, `it` a (B,) int32 tensor."""
    from goicp_tpu_torch.search.fused_stream import _pair_row, _stack_rows
    rows = []
    for r in range(pair_batch.data.shape[0]):
        st = device_init(_pair_row(pair_batch, r), cfg)
        st["it"] = torch.tensor(0, dtype=torch.int32, device=pair_batch.device)
        rows.append(st)
    return _stack_rows(rows)


def _batch_step(pairs: list, pair_batch: PairData, cfg: GoICPConfig,
                s: dict, rows, tables, p: dict, bufs) -> None:
    """One outer step of the batch rows `rows` (host indices), in place.
    One pop of every stepping row (search/transition.py: on the card one
    launch of advance), writing each row's lanes into a B-row lane
    batch whose other rows are done; then the inner searches of ALL rows
    as one lane batch (B x L lanes, the row of each lane in `tables`: on
    the card one launch of the inner run, search/inner.py::inner_run in
    mode "groups"), rows whose search ended early masked until every
    row's has ended; then one harvest of
    the stepping rows, one host read of which improved (and which
    converged at the pop), the ICP/compat refine block only for the rows
    that improved and did not converge, and one adoption of every
    stepping row, written into `s`.  Rows not in `rows` keep their
    state.  p: the run's B-row pop outputs (transition.outputs), written
    at the stepping rows; bufs: the run's search/args.py TransitionBuffers
    (the harvest's and the inner run's outputs from its two sets in turn,
    and the calls' argument blocks)."""
    from goicp_tpu_torch.search import fused_stream as fs
    dev = pair_batch.device
    B = len(pairs)
    rows = sorted(rows)
    p["lanes"]["done"].fill_(True)     # the idle rows' lanes stay done
    p = transition.advance("pop", cfg, pair_batch, s, rows, tables=tables,
                           out=p, bufs=bufs)
    cnt = torch.zeros((4, B), dtype=torch.int32, device=dev)
    bs = dict(inner=dict(p["lanes"], it=cnt[0], evals=cnt[1],
                         geom_surv=cnt[2], chem_corners=cnt[3]),
              pts_rot=p["pts"], mrd=p["mrd"])
    bs["inner"], _ = fs._inner_run(pair_batch, cfg, bs, tables, "groups",
                                   bufs=bufs)

    ist = bs["inner"]
    h = transition.harvest(cfg, dict(inner=ist, active=p["active"],
                                     R_lanes=p["R_lanes"],
                                     opt_err=s["opt_err"]), rows,
                           conv=p["converged"], bufs=bufs)
    flags = h["flags"].cpu().numpy()                 # the one host read
    r = pick.refine_rows(
        cfg, [(j, pairs[w], p["R_lanes"][w], ist["best_node"][w], h["ubs"][j],
               h["cand_R"][j], h["cand_t"][j]) for j, w in enumerate(rows)
              if (flags[j, 0] or not cfg.icp_on_improve) and not flags[j, 1]],
        len(rows), dev, bufs.record)
    transition.advance("adopt", cfg, pair_batch, s, rows, tables=tables,
                       h=h, r=r, p=p,
                       work=dict(evals=ist["evals"], iters=ist["it"],
                                 geom_surv=ist["geom_surv"],
                                 chem_corners=ist["chem_corners"]),
                       out=s, bufs=bufs)


def batch_run_chunk(pair_batch: PairData, cfg: GoICPConfig, state: dict,
                    steps: int) -> dict:
    """Advance every row of a batch state by at most `steps` outer
    iterations, each row exactly as device_run_chunk would (the outer
    steps of the rows run in lockstep).  `state` itself is not modified.
    The two-pass inner search (fused_inner=0) runs row by row."""
    from goicp_tpu_torch.search import fused_stream as fs
    s = fs._map_state(torch.clone, state)
    B = s["converged"].shape[0]
    pairs = [fs._pair_row(pair_batch, r) for r in range(B)]
    if not cfg.fused_inner:
        for r, pair in enumerate(pairs):
            fs._write_row(s, r, device_run_chunk(pair, cfg, fs._row(s, r),
                                                 steps))
        return s
    its = s["it"].cpu().numpy().astype(np.int64)
    limit = np.minimum(its + int(steps), cfg.max_outer_steps)
    tables = fs._window_tables(pair_batch, cfg, cfg.rot_batch * 8)
    pop = transition.outputs("pop", cfg, B, pair_batch.n_data_padded,
                             pair_batch.device)
    bufs = TransitionBuffers()
    while True:
        conv = s["converged"].cpu().numpy()
        rows = np.nonzero(~conv & (its < limit))[0]
        if not len(rows):
            break
        _batch_step(pairs, pair_batch, cfg, s, set(rows.tolist()), tables,
                    pop, bufs)
        its[rows] += 1
    return s


def result_to_numpy(res: DeviceResult) -> DeviceResult:
    """A DeviceResult of tensors -> the same of numpy arrays."""
    return DeviceResult(*(np.asarray(v.cpu()) for v in res))


def _batch_rows(pairs: list, n_live: int, cfg: GoICPConfig) -> DeviceResult:
    """Every row of `pairs` as one batch run to convergence, the rows from
    n_live on pre-converged (they never search)."""
    from goicp_tpu_torch.dist.mesh import stack_pairs
    pb = stack_pairs(pairs)
    s = batch_init(pb, cfg)
    s["converged"][n_live:] = True
    s = batch_run_chunk(pb, cfg, s, cfg.max_outer_steps)
    return result_to_numpy(device_finalize(s))


def register_device_batch(pairs, cfg: GoICPConfig, mesh=None
                          ) -> DeviceResult:
    """Register B same-bucket pairs (all on one device) as one batch run to
    convergence: every outer step of every row at once, the inner
    searches of all rows as one lane batch.  Each row's result equals its
    own register_device.  Returns a DeviceResult of numpy arrays with a
    leading pair axis, in the order of `pairs`.  mesh: every rank of it
    calls this with the same pairs; the pair axis splits over `data`
    (dist/mesh.map_pair_blocks) and every rank returns the whole batch."""
    pairs = list(pairs)
    if mesh is None:
        return _batch_rows(pairs, len(pairs), cfg)
    from goicp_tpu_torch.dist.mesh import map_pair_blocks
    return map_pair_blocks(mesh, pairs, lambda block, n_live: _batch_rows(
        block, n_live, cfg))
