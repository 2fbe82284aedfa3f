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
Python loop whose predicate is read on the host once per outer step, and
the inner search and ICP read theirs once per iteration.

With a mesh (dist/mesh.py), register_device splits each outer step's
rotation lanes over the mesh's `search` axis: every search rank runs the
inner search on its L/n lanes, the per-lane results are all-gathered, and
the cross-lane reductions (argmin, ICP seeds, adopt, merge) run replicated,
so the predicate every rank reads is the same.  register_device_batch
splits the pair axis over `data`.

The JAX package batches pairs by vmapping that loop.  Here a batch state
is the one-pair state with a leading row axis, and one batched outer step
pops and expands every unconverged row, runs the inner searches of all
rows as one lane batch through the per-lane-table kernels (the fused
stream's inner step, search/fused_stream.py), then adopts, prunes and
merges row by row.  Each row's trajectory is its own register_device's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.bounds.evaluate import rot_uncertainty
from goicp_tpu_torch.bounds.error import (Score, bnb_incompatibility_count,
                                          icp_chem_terms, initial_error,
                                          score_transform)
from goicp_tpu_torch.geom.rotation import rodrigues
from goicp_tpu_torch.icp.icp import icp_run
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.search.inner import (StepBuffers, _chem_reuse_active,
                                          inner_bnb, root_corner_values)
from goicp_tpu_torch.utils.fp32 import norm3, rotate

SQRT3 = 3.0 ** 0.5
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


# fixed coarse SO(3) multi-start seeds for the initial ICP (axis-angle;
# entry 0 = identity, the reference's only seed)
_INIT_SEED_RV = np.array(
    [[0.0, 0.0, 0.0],
     [np.pi / 2, 0.0, 0.0], [0.0, np.pi / 2, 0.0], [0.0, 0.0, np.pi / 2],
     [np.pi, 0.0, 0.0], [0.0, np.pi, 0.0], [0.0, 0.0, np.pi],
     [1.2091996, 1.2091996, 1.2091996]],    # 120-deg about (1,1,1)
    np.float32)


def _icp_from(pair: PairData, cfg: GoICPConfig, R0, t0, enabled=None):
    """ICP from K starts, each scored: (R, t, Score, icp_incomp), batched."""
    r = icp_run(pair.data, pair.model, R0, t0,
                inlier_num=pair.inlier_num, max_iter=cfg.icp_max_iter,
                err_diff=cfg.err_diff,
                data_mask=pair.data_mask if pair.padded else None,
                count=pair.inlier_f() if pair.dynamic_counts else None,
                dynamic_trim=pair.dynamic_counts and cfg.doTrim,
                enabled=enabled)
    sc = score_transform(pair, cfg, r.R, r.t, r.nn_idx)
    *_, inc = icp_chem_terms(pair, cfg, r.nn_idx)
    return r.R, r.t, sc, inc


def _pick(sc: Score, i) -> Score:
    return Score(*(x[i] for x in sc))


def _initial_incumbent(pair: PairData, cfg: GoICPConfig):
    """Initial incumbent: identity error + chem worst-case seeds, then ICP
    from identity (and, with cfg.init_seeds > 1, from K-1 coarse rotations
    too, adopting the best).
    Returns (opt_err0, opt_R0, opt_t0, comp0, terms0, better0)."""
    dev = pair.device
    init_err = initial_error(pair, cfg)
    K = max(1, min(int(cfg.init_seeds), len(_INIT_SEED_RV)))
    R_seeds = rodrigues(torch.as_tensor(_INIT_SEED_RV[:K], device=dev))
    Rs, ts, scs, incs = _icp_from(pair, cfg, R_seeds,
                                  torch.zeros((K, 3), device=dev))
    bi = 0 if K == 1 else torch.argmin(scs.error)
    sc0 = _pick(scs, bi)
    icp_R, icp_t = Rs[bi], ts[bi]
    icp0_incomp = incs[bi].to(torch.int32)
    better0 = sc0.error < init_err
    eye = torch.eye(3, device=dev)
    zero3 = torch.zeros(3, device=dev)
    opt_err0 = torch.where(better0, sc0.error, init_err)
    opt_R0 = torch.where(better0, icp_R, eye)
    opt_t0 = torch.where(better0, icp_t, zero3)
    comp0 = torch.where(better0, icp0_incomp,
                        torch.zeros_like(icp0_incomp))
    terms0 = torch.where(better0,
                         torch.stack([sc0.geom, sc0.incomp_term
                                      + sc0.nbr_term, sc0.fpfh_term]),
                         torch.stack([init_err, zero3[0], zero3[0]]))
    return opt_err0, opt_R0, opt_t0, comp0, terms0, better0


def _icp_best_of_seeds(pair: PairData, cfg: GoICPConfig,
                       R_lanes: torch.Tensor, best_nodes: torch.Tensor,
                       ubs: torch.Tensor, enabled=None):
    """ICP-refine the K lowest-ub lanes (ties: lower lane first), return
    the best-scoring seed: (icp_R, icp_t, score, icp_incomp).  enabled: a
    bool tensor — when False every ICP row runs zero iterations."""
    L = R_lanes.shape[0]
    K = min(cfg.icp_seeds, L)
    seed_lanes = torch.argsort(ubs, stable=True)[:K]
    seed_R = R_lanes[seed_lanes]                        # (K,3,3)
    seed_tn = best_nodes[seed_lanes]
    seed_t = seed_tn[:, :3] + seed_tn[:, 3:4] / 2.0     # (K,3)
    Rs, ts, scs, incs = _icp_from(pair, cfg, seed_R, seed_t, enabled)
    bi = torch.argmin(scs.error)
    return Rs[bi], ts[bi], _pick(scs, bi), incs[bi]


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


def _pop(pair: PairData, cfg: GoICPConfig, s: dict, min_lb=None) -> dict:
    """The head of an outer step: pop the rot_batch lowest-lb rotation
    nodes (sorted frontier), test convergence, expand 8 children each with
    the pi-ball filter, and rotate the data for every child lane.  min_lb:
    the lb convergence is tested on (None: the frontier's own minimum; the
    sharded engine passes the minimum over every rank's frontier)."""
    dev = pair.device
    Pr = cfg.rot_batch
    L = Pr * 8
    sse = torch.tensor(cfg.mse_margin, dtype=torch.float32,
                       device=dev) * pair.inlier_f()
    child_off = torch.tensor(
        [[j & 1, (j >> 1) & 1, (j >> 2) & 1] for j in range(8)],
        dtype=torch.float32, device=dev)
    pop_lb = s["fr_lbs"][:Pr]
    if min_lb is None:
        min_lb = pop_lb[0]
    # a NaN incumbent freezes the search immediately
    converged = torch.isinf(min_lb) | (s["opt_err"] - min_lb <= sse) \
        | torch.isnan(s["opt_err"])
    final_lb = torch.where(converged & ~s["converged"], min_lb,
                           s["final_lb"])
    parents = s["fr_nodes"][:Pr]                           # (Pr, 4)
    expand = torch.isfinite(pop_lb) \
        & (s["opt_err"] - pop_lb > sse) & ~converged       # (Pr,)

    cw = parents[:, 3:4] / 2.0                             # (Pr,1)
    cxyz = parents[:, None, 0:3] + child_off[None] * cw[:, None]
    centers = (cxyz + cw[:, None] / 2.0).reshape(L, 3)
    widths = cw[:, None].expand(Pr, 8, 1).reshape(L)
    child_nodes = torch.cat([cxyz.reshape(L, 3), widths[:, None]], dim=1)
    inside = (norm3(centers)
              - SQRT3 * widths / 2.0) <= math.pi
    active = inside & torch.repeat_interleave(expand, 8)
    R_lanes = rodrigues(centers)                           # (L,3,3)
    pts = rotate(R_lanes, pair.data)
    return dict(converged=converged, final_lb=final_lb, pop_lb=pop_lb,
                expand=expand, fr_lbs=s["fr_lbs"][Pr:],
                fr_nodes=s["fr_nodes"][Pr:], child_nodes=child_nodes,
                widths=widths, active=active, R_lanes=R_lanes, pts=pts)


def _merge_children(cfg: GoICPConfig, p: dict, lb_safe, opt_err):
    """Prune the popped children against the incumbent and merge them into
    the rest of the (sorted) frontier with one stable sort.  Returns the
    kept lbs and nodes (capacity Cr) and the minimum finite lb dropped."""
    Cr = cfg.device_rot_capacity
    lbs_new = torch.where(p["active"] & (lb_safe < opt_err), lb_safe, INF)
    all_lbs = torch.cat([p["fr_lbs"], lbs_new])            # (Cr - Pr + L)
    all_nodes = torch.cat([p["fr_nodes"], p["child_nodes"]])
    order = torch.argsort(all_lbs, stable=True)
    keep_lbs = all_lbs[order[:Cr]]
    keep_nodes = all_nodes[order[:Cr]]
    dropped = all_lbs[order[Cr:]]
    min_drop = torch.amin(torch.where(torch.isfinite(dropped), dropped, INF))
    # also prune kept nodes against the new incumbent
    keep_lbs = torch.where(keep_lbs >= opt_err, INF, keep_lbs)
    return keep_lbs, keep_nodes, min_drop


def _adopt(pair: PairData, cfg: GoICPConfig, s: dict, p: dict, cand: dict,
           icp: dict, bnb_improved, icp_improved, lb_safe, work: dict
           ) -> dict:
    """The tail of an outer step: adopt the ICP result when it beats the
    candidate, else the candidate; prune and merge the children into the
    frontier; freeze a converged search.  cand: the best lane's ub, R, t,
    terms; icp: the refined R, t, error, terms, incompatibility count and
    the candidate's BnB count; work: the inner search's evals, iters,
    geom_surv, chem_corners."""
    dev = pair.device

    def pick(icp_v, bnb_v, old_v):
        return torch.where(icp_improved, icp_v,
                           torch.where(bnb_improved, bnb_v, old_v))

    opt_err = pick(icp["err"], cand["ub"], s["opt_err"])
    opt_R = pick(icp["R"], cand["R"], s["opt_R"])
    opt_t = pick(icp["t"], cand["t"], s["opt_t"])
    comp = pick(icp["incomp"].to(torch.int32), icp["bnb_comp"], s["comp"])
    terms = pick(icp["terms"], cand["terms"], s["terms"])
    last_icp = torch.where(icp_improved, True,
                           torch.where(bnb_improved, False, s["last_icp"]))

    keep_lbs, keep_nodes, min_drop = _merge_children(cfg, p, lb_safe,
                                                     opt_err)

    # frozen when converged
    frozen = s["converged"] | p["converged"]

    def keep(new, old):
        return torch.where(frozen, old, new)

    def add(total, inc):
        return total + torch.where(frozen, 0, inc).to(total.dtype)

    return dict(
        fr_nodes=keep(keep_nodes, s["fr_nodes"]),
        fr_lbs=keep(keep_lbs, s["fr_lbs"]),
        opt_err=keep(opt_err, s["opt_err"]),
        opt_R=keep(opt_R, s["opt_R"]),
        opt_t=keep(opt_t, s["opt_t"]),
        comp=keep(comp, s["comp"]),
        terms=keep(terms, s["terms"]),
        last_icp=keep(last_icp, s["last_icp"]),
        min_dropped=keep(torch.minimum(s["min_dropped"], min_drop),
                         s["min_dropped"]),
        it=s["it"] + 1,
        evals=add(s["evals"], work["evals"]),
        inner_it=add(s["inner_it"],
                     torch.as_tensor(work["iters"], device=dev)),
        icp_runs=add(s["icp_runs"],
                     bnb_improved.to(torch.int32)
                     if cfg.icp_on_improve
                     else torch.tensor(1, device=dev)),
        geom_surv=add(s["geom_surv"], work["geom_surv"]),
        chem_corners=add(s["chem_corners"],
                         torch.as_tensor(work["chem_corners"], device=dev)),
        converged=frozen,
        final_lb=p["final_lb"],
    )


def _make_body(pair: PairData, cfg: GoICPConfig, mesh=None):
    """One outer BnB step: pop -> expand -> inner search -> ICP -> adopt ->
    prune/merge.  With a mesh the inner search runs on this rank's block
    of the lanes (its kernels device-local) and its results are
    all-gathered over `search` (dist/mesh.gather_lanes)."""
    def inner(pts, widths, active, inc, with_rot_uncertainty, fused):
        if mesh is None:
            return inner_bnb(pair, cfg, pts, widths, active, inc,
                             with_rot_uncertainty=with_rot_uncertainty,
                             fused=fused)
        from goicp_tpu_torch.dist.mesh import gather_lanes
        mine = mesh.block(pts.shape[0], "search")
        return gather_lanes(inner_bnb(
            pair, cfg, pts[mine], widths[mine], active[mine], inc,
            with_rot_uncertainty=with_rot_uncertainty, fused=fused), mesh)

    def body(s):
        p = _pop(pair, cfg, s)
        active = p["active"]
        if cfg.fused_inner:
            res_ub = inner(p["pts"], p["widths"], active, s["opt_err"],
                           False, True)
            res_lb = res_ub
        else:
            res_ub = inner(p["pts"], p["widths"], active, s["opt_err"],
                           False, False)
        ubs = torch.where(active, res_ub.best_err, INF)
        best_lane = torch.argmin(ubs)
        cand_ub = ubs[best_lane]
        incumbent = torch.minimum(s["opt_err"], cand_ub)
        if not cfg.fused_inner:
            res_lb = inner(p["pts"], p["widths"], active, incumbent, True,
                           False)

        # ---- candidate adoption (BnB) + ICP refinement ----
        tn = res_ub.best_node[best_lane]
        cand = dict(ub=cand_ub, R=p["R_lanes"][best_lane],
                    t=tn[:3] + tn[3] / 2.0,
                    terms=res_ub.ub_terms[best_lane])
        bnb_improved = ~(cand_ub >= s["opt_err"])     # NaN-infectious <

        # ICP gating (refine only on improvement, jly_goicp.cpp:771-854)
        do_icp = bnb_improved if cfg.icp_on_improve else None
        icp_R, icp_t, sc, icp_incomp = _icp_best_of_seeds(
            pair, cfg, p["R_lanes"], res_ub.best_node, ubs, enabled=do_icp)
        icp_improved = ~(sc.error >= incumbent)       # NaN-infectious <
        if cfg.icp_on_improve:
            icp_improved = icp_improved & bnb_improved
        icp = dict(R=icp_R, t=icp_t, err=sc.error,
                   terms=torch.stack([sc.geom, sc.incomp_term + sc.nbr_term,
                                      sc.fpfh_term]),
                   incomp=icp_incomp,
                   bnb_comp=bnb_incompatibility_count(pair, cfg, cand["R"],
                                                      cand["t"]))
        if cfg.fused_inner:
            work = dict(evals=res_ub.evals, iters=res_ub.iters,
                        geom_surv=res_ub.geom_surv,
                        chem_corners=res_ub.chem_corners)
        else:
            work = dict(evals=res_ub.evals + res_lb.evals,
                        iters=res_ub.iters + res_lb.iters,
                        geom_surv=res_ub.geom_surv + res_lb.geom_surv,
                        chem_corners=res_ub.chem_corners
                        + res_lb.chem_corners)
        return _adopt(pair, cfg, s, p, cand, icp, bnb_improved,
                      icp_improved, res_lb.lb_safe, work)

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
    while it < limit and not bool(s["converged"]):
        s = body(s)
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
                s: dict, rows, tables) -> None:
    """One outer step of the batch rows `rows` (host indices), in place.
    Each row pops and expands on its own; then the inner searches of ALL
    rows run as one lane batch (B x L lanes, the row of each lane in
    `tables`, so each inner iteration is one K3 and one K4 launch), rows
    whose search ended early masked until every row's has ended; then
    each row's ICP / adopt / prune / merge, ICP only for the rows that
    improved (one host read says which).  Rows not in `rows` keep their
    state."""
    from goicp_tpu_torch.search import fused_stream as fs
    dev = pair_batch.device
    L = cfg.rot_batch * 8
    ndp = pair_batch.n_data_padded
    reuse = _chem_reuse_active(cfg)
    stepping = {}
    inner, pts, mrd = [], [], []
    for r, pair in enumerate(pairs):
        st = fs._row(s, r)
        if r in rows:
            p = _pop(pair, cfg, st)
            ist = fs._inner_init(cfg, L, st["opt_err"], root_cv=(
                root_corner_values(pair, cfg, p["pts"]) if reuse else None))
            ist["done"] = ~p["active"]
            stepping[r] = (st, p)
            pts.append(p["pts"])
            mrd.append(rot_uncertainty(p["widths"], pair.norm_data))
        else:
            ist = fs._inner_init(cfg, L, st["opt_err"])
            ist["done"] = torch.ones((L,), dtype=torch.bool, device=dev)
            pts.append(torch.zeros((L, ndp, 3), dtype=torch.float32,
                                   device=dev))
            mrd.append(torch.zeros((L, ndp), dtype=torch.float32,
                                   device=dev))
        inner.append(ist)
    bs = dict(inner=fs._stack_rows(inner), pts_rot=torch.stack(pts),
              mrd=torch.stack(mrd))
    bufs = StepBuffers()
    while True:
        live = ~fs._inner_complete(cfg, bs)
        if not bool(torch.any(live)):
            break
        bs["inner"] = fs._inner_step(pair_batch, cfg, bs, tables, live, bufs)

    done = {r: dict(inner=fs._row(bs["inner"], r), active=p["active"],
                    R_lanes=p["R_lanes"]) for r, (_, p) in stepping.items()}
    hs = {r: fs._harvest(d) for r, d in done.items()}
    improved = {r: ~(hs[r]["cand_ub"] >= stepping[r][0]["opt_err"])
                for r in stepping}                   # NaN-infectious <
    order = sorted(stepping)
    if cfg.icp_on_improve:
        do_icp = dict(zip(order, torch.stack(
            [improved[r] for r in order]).cpu().numpy()))
    else:
        do_icp = dict.fromkeys(order, True)
    for r in order:
        st, p = stepping[r]
        h, ist = hs[r], done[r]["inner"]
        if do_icp[r]:
            ref = fs._refine(pairs[r], cfg, done[r], h)
            incumbent = torch.minimum(st["opt_err"], h["cand_ub"])
            icp_improved = ~(ref["icp_err"] >= incumbent)
        else:
            ref = fs._refine_dummy(dev)
            icp_improved = torch.tensor(False, device=dev)
        cand = dict(ub=h["cand_ub"], R=h["cand_R"], t=h["cand_t"],
                    terms=h["cand_terms"])
        icp = dict(R=ref["icp_R"], t=ref["icp_t"], err=ref["icp_err"],
                   terms=ref["icp_terms"], incomp=ref["icp_incomp"],
                   bnb_comp=ref["bnb_comp"])
        work = dict(evals=ist["evals"], iters=ist["it"],
                    geom_surv=ist["geom_surv"],
                    chem_corners=ist["chem_corners"])
        fs._write_row(s, r, _adopt(pairs[r], cfg, st, p, cand, icp,
                                   improved[r], icp_improved, h["lb_safe"],
                                   work))


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
    while True:
        conv = s["converged"].cpu().numpy()
        rows = np.nonzero(~conv & (its < limit))[0]
        if not len(rows):
            break
        _batch_step(pairs, pair_batch, cfg, s, set(rows.tolist()), tables)
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
