"""Device-side Go-ICP registration of one pair.

Port of goicp_tpu/search/device_engine.py (`register_device` without a
mesh).  The rotation frontier is a fixed-capacity tensor on the device; one
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
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.bounds.error import (Score, bnb_incompatibility_count,
                                          icp_chem_terms, initial_error,
                                          score_transform)
from goicp_tpu_torch.geom.rotation import rodrigues
from goicp_tpu_torch.icp.icp import icp_run
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.search.inner import inner_bnb

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


def _make_body(pair: PairData, cfg: GoICPConfig):
    """One outer BnB step: pop -> expand -> inner search -> ICP -> adopt ->
    prune/merge."""
    dev = pair.device
    Pr = cfg.rot_batch
    L = Pr * 8
    sse = torch.tensor(cfg.mse_margin, dtype=torch.float32,
                       device=dev) * pair.inlier_f()
    child_off = torch.tensor(
        [[j & 1, (j >> 1) & 1, (j >> 2) & 1] for j in range(8)],
        dtype=torch.float32, device=dev)
    Cr = cfg.device_rot_capacity

    def inner(pts, widths, active, inc, with_rot_uncertainty, fused):
        return inner_bnb(pair, cfg, pts, widths, active, inc,
                         with_rot_uncertainty=with_rot_uncertainty,
                         fused=fused)

    def body(s):
        # ---- pop the Pr lowest-lb rotation nodes (sorted frontier) ----
        pop_lb = s["fr_lbs"][:Pr]
        min_lb = pop_lb[0]
        # a NaN incumbent freezes the search immediately
        converged = torch.isinf(min_lb) | (s["opt_err"] - min_lb <= sse) \
            | torch.isnan(s["opt_err"])
        final_lb = torch.where(converged & ~s["converged"], min_lb,
                               s["final_lb"])
        parents = s["fr_nodes"][:Pr]                       # (Pr, 4)
        fr_lbs = s["fr_lbs"][Pr:]
        fr_nodes_rest = s["fr_nodes"][Pr:]
        expand = torch.isfinite(pop_lb) \
            & (s["opt_err"] - pop_lb > sse) & ~converged   # (Pr,)

        # ---- expand 8 children per parent, pi-ball filter ----
        cw = parents[:, 3:4] / 2.0                         # (Pr,1)
        cxyz = parents[:, None, 0:3] + child_off[None] * cw[:, None]
        centers = (cxyz + cw[:, None] / 2.0).reshape(L, 3)
        widths = cw[:, None].expand(Pr, 8, 1).reshape(L)
        child_nodes = torch.cat([cxyz.reshape(L, 3), widths[:, None]], dim=1)
        inside = (torch.linalg.norm(centers, dim=1)
                  - SQRT3 * widths / 2.0) <= math.pi
        active = inside & torch.repeat_interleave(expand, 8)

        # ---- rotate + inner pass(es) ----
        R_lanes = rodrigues(centers)                       # (L,3,3)
        pts = torch.einsum("lij,nj->lni", R_lanes, pair.data)
        if cfg.fused_inner:
            res_ub = inner(pts, widths, active, s["opt_err"], False, True)
            res_lb = res_ub
        else:
            res_ub = inner(pts, widths, active, s["opt_err"], False, False)
        ubs = torch.where(active, res_ub.best_err, INF)
        best_lane = torch.argmin(ubs)
        cand_ub = ubs[best_lane]
        incumbent = torch.minimum(s["opt_err"], cand_ub)
        if not cfg.fused_inner:
            res_lb = inner(pts, widths, active, incumbent, True, False)

        # ---- candidate adoption (BnB) + ICP refinement ----
        cand_R = R_lanes[best_lane]
        tn = res_ub.best_node[best_lane]
        cand_t = tn[:3] + tn[3] / 2.0
        cand_terms = res_ub.ub_terms[best_lane]
        bnb_improved = ~(cand_ub >= s["opt_err"])     # NaN-infectious <

        # ICP gating (refine only on improvement, jly_goicp.cpp:771-854)
        do_icp = bnb_improved if cfg.icp_on_improve else None
        icp_R, icp_t, sc, icp_incomp = _icp_best_of_seeds(
            pair, cfg, R_lanes, res_ub.best_node, ubs, enabled=do_icp)
        icp_improved = ~(sc.error >= incumbent)       # NaN-infectious <
        if cfg.icp_on_improve:
            icp_improved = icp_improved & bnb_improved

        # adopt: ICP result when it beats the candidate; else the candidate
        opt_err = torch.where(icp_improved, sc.error,
                              torch.where(bnb_improved, cand_ub,
                                          s["opt_err"]))
        opt_R = torch.where(icp_improved, icp_R,
                            torch.where(bnb_improved, cand_R, s["opt_R"]))
        opt_t = torch.where(icp_improved, icp_t,
                            torch.where(bnb_improved, cand_t, s["opt_t"]))
        bnb_comp = bnb_incompatibility_count(pair, cfg, cand_R, cand_t)
        comp = torch.where(icp_improved, icp_incomp.to(torch.int32),
                           torch.where(bnb_improved, bnb_comp, s["comp"]))
        terms = torch.where(
            icp_improved,
            torch.stack([sc.geom, sc.incomp_term + sc.nbr_term,
                         sc.fpfh_term]),
            torch.where(bnb_improved, cand_terms, s["terms"]))
        last_icp = torch.where(icp_improved, True,
                               torch.where(bnb_improved, False,
                                           s["last_icp"]))

        # ---- prune + merge children into the frontier ----
        lbs_new = torch.where(active & (res_lb.lb_safe < opt_err),
                              res_lb.lb_safe, INF)
        all_lbs = torch.cat([fr_lbs, lbs_new])             # (Cr - Pr + L)
        all_nodes = torch.cat([fr_nodes_rest, child_nodes])
        order = torch.argsort(all_lbs, stable=True)
        keep_lbs = all_lbs[order[:Cr]]
        keep_nodes = all_nodes[order[:Cr]]
        dropped = all_lbs[order[Cr:]]
        min_drop = torch.amin(torch.where(torch.isfinite(dropped), dropped,
                                          INF))
        # also prune kept nodes against the new incumbent
        keep_lbs = torch.where(keep_lbs >= opt_err, INF, keep_lbs)

        # frozen when converged
        frozen = s["converged"] | converged

        def keep(new, old):
            return torch.where(frozen, old, new)

        def add(total, inc):
            return total + torch.where(frozen, 0, inc).to(total.dtype)

        if cfg.fused_inner:
            evals, iters = res_ub.evals, res_ub.iters
            surv, corners = res_ub.geom_surv, res_ub.chem_corners
        else:
            evals = res_ub.evals + res_lb.evals
            iters = res_ub.iters + res_lb.iters
            surv = res_ub.geom_surv + res_lb.geom_surv
            corners = res_ub.chem_corners + res_lb.chem_corners
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
            evals=add(s["evals"], evals),
            inner_it=add(s["inner_it"], torch.tensor(iters, device=dev)),
            icp_runs=add(s["icp_runs"],
                         bnb_improved.to(torch.int32)
                         if cfg.icp_on_improve
                         else torch.tensor(1, device=dev)),
            geom_surv=add(s["geom_surv"], surv),
            chem_corners=add(s["chem_corners"],
                             torch.tensor(corners, device=dev)),
            converged=frozen,
            final_lb=final_lb,
        )

    return body


def device_finalize(state: dict) -> DeviceResult:
    """Search state -> DeviceResult (gap folds capacity-dropped lbs)."""
    s = state
    remaining = torch.minimum(torch.amin(s["fr_lbs"]), s["min_dropped"])
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


def register_device(pair: PairData, cfg: GoICPConfig) -> DeviceResult:
    """The whole Go-ICP search for one pair, on the pair's device."""
    s = device_init(pair, cfg)
    body = _make_body(pair, cfg)
    while s["it"] < cfg.max_outer_steps and not bool(s["converged"]):
        s = body(s)
    return device_finalize(s)
