"""Rotation-subtree sharding with periodic frontier rebalancing.

Port of goicp_tpu/search/sharded_engine.py on torch.distributed.  The
device engine with a mesh (device_engine.register_device(mesh=)) keeps ONE
replicated rotation frontier and splits each step's lanes over the
`search` axis.  Here every search rank keeps its OWN rotation frontier (an
SPMD priority queue): each rank pops its local lowest-lb cubes, runs the
lane-batched inner translation BnB on its own lanes, and synchronizes with
three collectives per outer step:

  * global convergence min — the search ends when the minimum lb over
    every rank's frontier crosses the reference's threshold
    (jly_goicp.cpp:685);
  * incumbent all-gather — each rank's best proposal (post-ICP error, R,
    t, comp, terms, which of the two) is all-gathered and the argmin
    adopted everywhere (the collective analogue of the scalar optError
    update, jly_goicp.cpp:771-781);
  * periodic frontier rebalance — every `rebalance_every` steps the local
    frontiers are all-gathered, sorted by lb (stable: equal and INF lbs
    keep their rank order, which decides who gets which node) and re-dealt
    strided (rank d takes sorted entries d, d+n, d+2n, ...).  The union of
    the frontiers is kept exactly, and each rank gets an equal share of
    every lb stratum.

Every branch the host takes reads a replicated value (the all-reduced
minimum, the adopted incumbent, the step count), so the ranks enter every
collective together.  Epsilon-optimality matches the unsharded engine:
per-node threshold discards use the reference's own rule, and
capacity-dropped lbs fold into the reported gap (a min over the ranks).
"""

from __future__ import annotations

import numpy as np
import torch

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.dist.mesh import MAX, MIN, SUM, Mesh
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.search import pick
from goicp_tpu_torch.search.device_engine import (DeviceResult, _pop,
                                                  device_init)
from goicp_tpu_torch.search.args import TransitionBuffers
from goicp_tpu_torch.search.inner import inner_bnb
from goicp_tpu_torch.search.transition import _merge_children

INF = float("inf")
AXIS = "search"


def _presplit_root(cfg: GoICPConfig, n_shards: int) -> np.ndarray:
    """Split the root rotation cube to depth d with 8^d >= n_shards, so
    every rank starts with distinct subtrees (all at valid lb=0).
    Returns (8^d, 4) float32 [x, y, z, w]."""
    depth = 0
    while 8 ** depth < n_shards:
        depth += 1
    depth = max(depth, 1)
    cubes = np.array([[cfg.rotMinX, cfg.rotMinY, cfg.rotMinZ,
                       cfg.rotWidth]], np.float32)
    off = np.array([[j & 1, (j >> 1) & 1, (j >> 2) & 1] for j in range(8)],
                   np.float32)
    for _ in range(depth):
        w = cubes[:, 3:4] / 2.0
        xyz = cubes[:, None, 0:3] + off[None] * w[:, None]
        cubes = np.concatenate(
            [xyz.reshape(-1, 3),
             np.repeat(w, 8, axis=0).reshape(-1, 1)], axis=1)
    return cubes


def _local_init(pair: PairData, cfg: GoICPConfig, mesh: Mesh) -> dict:
    """The replicated initial incumbent (device_init's) with this rank's
    strided share of the pre-split root as its frontier."""
    n, me = mesh.n_search, mesh.search_rank
    dev = pair.device
    s = device_init(pair, cfg)
    presplit = torch.as_tensor(_presplit_root(cfg, n), device=dev)
    M = presplit.shape[0]
    m_local = -(-M // n)
    ids = me + n * torch.arange(m_local, device=dev)
    s["fr_nodes"][:m_local] = presplit[torch.clamp(ids, max=M - 1)]
    s["fr_lbs"][:m_local] = torch.where(ids < M, 0.0, INF)
    s["good_pops"] = torch.zeros_like(s["evals"])
    s["tot_pops"] = torch.zeros_like(s["evals"])
    return s


def register_device_sharded(pair: PairData, cfg: GoICPConfig, mesh: Mesh,
                            rebalance_every: int = 4,
                            stats: bool = False) -> DeviceResult:
    """Register one pair with the rotation frontier sharded over the mesh's
    `search` axis; every rank of the mesh calls this with the same pair and
    gets the result.  rebalance_every=0 disables rebalancing (pure static
    subtree partitioning, the baseline of the cadence comparison).

    stats=True also returns pop_quality: (result, pop_quality), the
    fraction of expanded pops whose lb lies within the GLOBAL top n*Pr of
    the union of local frontiers at pop time (costs one all-gather of n*Pr
    lbs per step).

    outer_iters counts the lockstep steps; evals, icp_runs, geom_surv and
    chem_corners are summed over the ranks, inner_iters is the largest
    rank's."""
    if not cfg.fused_inner:
        raise ValueError("sharded engine requires fused_inner=1")
    n, me = mesh.n_search, mesh.search_rank
    Pr = cfg.rot_batch
    Cr = cfg.device_rot_capacity
    dev = pair.device
    s = _local_init(pair, cfg, mesh)
    bufs = TransitionBuffers()      # the pops' outputs, the refine record
    it = 0
    while it < cfg.max_outer_steps and not bool(s["converged"]):
        g_min = mesh.all_reduce(s["fr_lbs"][0], MIN, AXIS)
        p = _pop(pair, cfg, s, min_lb=g_min, bufs=bufs)
        expand = p["expand"]
        if stats:
            # the global top-(n*Pr) threshold over the union of the local
            # frontiers: each rank's top n*Pr prefix suffices; near
            # exhaustion (fewer than n*Pr finite lbs) nothing is counted
            g_pre = mesh.all_gather(s["fr_lbs"][:min(n * Pr, Cr)],
                                    AXIS).reshape(-1)
            tau = torch.sort(g_pre).values[n * Pr - 1]
            ok = torch.sum(torch.isfinite(g_pre)) >= n * Pr
            good = torch.where(ok, torch.sum((p["pop_lb"] <= tau) & expand),
                               0)
            tot = torch.where(ok, torch.sum(expand), 0)
        else:
            good = tot = 0

        # ---- this rank's lanes: the fused inner search, device-local ----
        active = p["active"]
        res = inner_bnb(pair, cfg, p["pts"], p["widths"], active,
                        s["opt_err"], with_rot_uncertainty=False, fused=True,
                        lanes0=p["lanes"], mrd=p["mrd"])
        ubs = torch.where(active, res.best_err, INF)
        best_lane = torch.argmin(ubs)
        cand_ub = ubs[best_lane]
        cand_R = p["R_lanes"][best_lane]
        tn = res.best_node[best_lane]
        cand_t = tn[:3] + tn[3] / 2.0

        # ---- local ICP seeds (gated on improvement) -> local proposal ----
        # (the seeds, the event, the pick and the candidate's count into
        # the run's refine record: one launch, no host read)
        do_icp = (cand_ub < s["opt_err"]) if cfg.icp_on_improve else None
        rec = pick.refine_rows(cfg, [(0, pair, p["R_lanes"], res.best_node,
                                      ubs, cand_R, cand_t)], 1, dev,
                               bufs.record, enabled=do_icp)
        icp = {k: v[0] for k, v in rec.items()}
        icp_better = icp["icp_err"] < cand_ub
        if cfg.icp_on_improve:
            icp_better = icp_better & do_icp

        def prop(icp_v, bnb_v):
            return torch.where(icp_better, icp_v, bnb_v).reshape(-1).float()

        # one float32 row per rank: err, R (9), t (3), comp (exact below
        # 2^24), terms (3), whether ICP made it
        mine = torch.cat([
            prop(icp["icp_err"], cand_ub), prop(icp["icp_R"], cand_R),
            prop(icp["icp_t"], cand_t),
            prop(icp["icp_incomp"], icp["bnb_comp"]),
            prop(icp["icp_terms"], res.ub_terms[best_lane]),
            icp_better.reshape(1).float()])

        # ---- incumbent all-gather: adopt the global best proposal ----
        g = mesh.all_gather(mine, AXIS)                    # (n, 18)
        win = g[torch.argmin(g[:, 0])]
        improved = ~(win[0] >= s["opt_err"])               # NaN-infectious <

        def adopt(new, old):
            return torch.where(improved, new.reshape(old.shape).to(old.dtype),
                               old)

        opt_err = adopt(win[0], s["opt_err"])
        new = dict(opt_err=opt_err, opt_R=adopt(win[1:10], s["opt_R"]),
                   opt_t=adopt(win[10:13], s["opt_t"]),
                   comp=adopt(win[13], s["comp"]),
                   terms=adopt(win[14:17], s["terms"]),
                   last_icp=adopt(win[17] > 0, s["last_icp"]))

        # ---- prune + merge children into the LOCAL frontier ----
        keep_lbs, keep_nodes, min_drop = _merge_children(cfg, p, res.lb_safe,
                                                         opt_err)

        # ---- periodic lossless rebalance (all-gather + strided deal) ----
        if rebalance_every > 0 and (it + 1) % rebalance_every == 0:
            g_fr = mesh.all_gather(torch.cat([keep_lbs[:, None], keep_nodes],
                                             dim=1), AXIS).reshape(-1, 5)
            order = torch.argsort(g_fr[:, 0], stable=True)
            dealt = g_fr[order[me + n * torch.arange(Cr, device=dev)]]
            keep_lbs, keep_nodes = dealt[:, 0], dealt[:, 1:]

        frozen = s["converged"] | p["converged"]

        def keep(new_v, old_v):
            return torch.where(frozen, old_v, new_v)

        def add(total, inc):
            inc = torch.as_tensor(inc, device=dev)
            return total + torch.where(frozen, 0, inc).to(total.dtype)

        new.update(fr_nodes=keep_nodes, fr_lbs=keep_lbs,
                   min_dropped=torch.minimum(s["min_dropped"], min_drop))
        s = dict(
            {k: keep(v, s[k]) for k, v in new.items()},
            it=s["it"] + 1,
            evals=add(s["evals"], res.evals),
            inner_it=add(s["inner_it"], res.iters),
            icp_runs=add(s["icp_runs"], do_icp.to(torch.int32)
                         if cfg.icp_on_improve else 1),
            geom_surv=add(s["geom_surv"], res.geom_surv),
            chem_corners=add(s["chem_corners"], res.chem_corners),
            good_pops=add(s["good_pops"], good),
            tot_pops=add(s["tot_pops"], tot),
            converged=frozen, final_lb=p["final_lb"])
        it += 1

    # the global gap: the min over the ranks of remaining / dropped lbs
    remaining = mesh.all_reduce(torch.minimum(torch.amin(s["fr_lbs"]),
                                              s["min_dropped"]), MIN, AXIS)
    bound = torch.minimum(torch.where(s["converged"], s["final_lb"],
                                      remaining), s["opt_err"])
    gap = torch.clamp(s["opt_err"] - bound, min=0.0)
    sums = mesh.all_reduce(torch.stack([
        s[k].to(torch.int64) for k in ("evals", "icp_runs", "geom_surv",
                                       "chem_corners", "good_pops",
                                       "tot_pops")]), SUM, AXIS)
    i32 = [v.to(torch.int32) for v in sums]
    out = DeviceResult(
        error=s["opt_err"], R=s["opt_R"], t=s["opt_t"], opt_comp=s["comp"],
        terms=s["terms"], last_icp=s["last_icp"], outer_iters=s["it"],
        evals=i32[0], gap=gap, converged=s["converged"],
        inner_iters=mesh.all_reduce(s["inner_it"], MAX, AXIS),
        icp_runs=i32[1], geom_surv=i32[2], chem_corners=i32[3])
    if stats:
        return out, float(sums[4]) / max(float(sums[5]), 1.0)
    return out
