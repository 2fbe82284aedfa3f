"""Inner translation BnB: lane-batched array frontier.

Port of goicp_tpu/search/inner.py.  Reference: GoICP::InnerBnB
(jly_goicp.cpp:286-579), a best-first priority queue over translation
subcubes.  Here L rotation lanes run their inner searches at once as a
leading batch axis; each lane's queue is a fixed-capacity frontier tensor,
kept sorted by lower bound.  Every iteration pops the P lowest-lb nodes,
evaluates all 8P children (bounds/evaluate.py), prunes and re-inserts with
one stable sort.  Epsilon-optimality under capacity overflow is kept by
folding the minimum lb of dropped nodes into the returned lower bound.

The JAX package's lax.while_loop is a Python loop here: the loop predicate
is read on the host once per iteration.  Lanes that finished keep their
state; staged lane compaction (L -> L/2 -> L/4) gathers the still-active
lanes into a narrower batch, which changes no lane's trajectory.

Two knobs change how an iteration does its work, never what it finds:
cfg.sorted_merge re-inserts the children by a rank merge against the
already-sorted frontier instead of one sort of both (the same order), and
cfg.chem_survivors > 0 evaluates the chem corner terms only for the lowest-
lb geometric survivors (two-phase bounds; the full budget 8 * trans_pop
gives the lattice path's trajectory).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.bounds.evaluate import (_CHILD_CORNER_TO_LATTICE,
                                             _CHILD_OFFSETS,
                                             _LATTICE_OFFSETS,
                                             chem_bounds_from_lattice,
                                             chem_corner_values,
                                             geometric_bounds,
                                             geometric_bounds_fused,
                                             rot_uncertainty)
from goicp_tpu_torch.pipeline.prepare import PairData

INF = float("inf")


class InnerResult(NamedTuple):
    best_err: torch.Tensor     # (L,) best achievable error found (ub pass)
    best_node: torch.Tensor    # (L, 4) x,y,z,w of the winning trans node
    lb_safe: torch.Tensor      # (L,) valid lower bound for the rot cube
    ub_terms: torch.Tensor     # (L, 3) [geom, incomp, fpfh] of adopted ub
    iters: int                 # iterations executed
    evals: torch.Tensor        # bound evaluations performed (0-d)
    geom_surv: torch.Tensor    # children surviving the geometric lb (0-d)
    chem_corners: int          # chem corner evaluations issued


def _chem_active(cfg: GoICPConfig) -> bool:
    return (cfg.regularization > 0 or cfg.regularizationNeighbors > 0
            or (cfg.regularizationFPFH > 0 and cfg.cfpfh != 0))


def _chem_terms(cfg: GoICPConfig) -> tuple:
    """Active chem term keys, in the order chem_corner_values emits them;
    the corner-reuse payload stores 8 values per term."""
    terms = []
    if cfg.regularization > 0:
        terms.append("incomp")
    if cfg.regularizationFPFH > 0 and cfg.cfpfh != 0:
        terms.append("fpfh")
    if cfg.regularizationNeighbors > 0:
        terms.append("nbr")
    return tuple(terms)


def _chem_reuse_active(cfg: GoICPConfig) -> bool:
    """Corner reuse (cfg.chem_reuse): every frontier node carries the chem
    values of its own 8 cube corners, so a pop's 3x3x3 lattice only needs
    the 19 NEW points from the kernel."""
    return bool(cfg.chem_reuse) and _chem_active(cfg) \
        and cfg.chem_survivors <= 0


# parent's own cube corner c sits at lattice offset 2 * _CHILD_OFFSETS[c]
_EVEN_LATTICE = np.array(
    [((2 * o[2]) * 3 + 2 * o[1]) * 3 + 2 * o[0] for o in _CHILD_OFFSETS],
    dtype=np.int64)                                   # (8,)
_ODD_LATTICE = np.array(
    [i for i in range(27) if i not in set(_EVEN_LATTICE.tolist())],
    dtype=np.int64)                                   # (19,)
# lattice index i takes its value from [stored corner 0..7 | kernel odd
# point 0..18] under corner reuse
_LAT_FROM_STORED = np.zeros(27, np.int64)
for _i, _e in enumerate(_EVEN_LATTICE):
    _LAT_FROM_STORED[_e] = _i
for _i, _o in enumerate(_ODD_LATTICE):
    _LAT_FROM_STORED[_o] = 8 + _i


def root_corner_values(pair: PairData, cfg: GoICPConfig,
                       pts_rot: torch.Tensor) -> torch.Tensor:
    """Chem values at the ROOT translation cube's 8 corners, (L, 8*T) in
    _chem_terms order — the corner-reuse seed for a fresh inner search."""
    L = pts_rot.shape[0]
    dev = pts_rot.device
    root = torch.tensor([cfg.transMinX, cfg.transMinY, cfg.transMinZ],
                        dtype=torch.float32, device=dev)
    off = torch.as_tensor(_CHILD_OFFSETS, dtype=torch.float32, device=dev)
    corners = root[None] + off * torch.tensor(cfg.transWidth,
                                              dtype=torch.float32, device=dev)
    corners = corners[None].expand(L, 8, 3).contiguous()
    vals = chem_corner_values(pair, cfg, pts_rot, corners)
    return torch.cat([vals[k] for k in _chem_terms(cfg)], dim=-1)


_PER_LANE = ("nodes", "lbs", "opt_err", "thr", "best_node", "ub_terms",
             "min_dropped", "done", "cvals")


def inner_bnb(pair: PairData, cfg: GoICPConfig, pts_rot: torch.Tensor,
              rot_widths: torch.Tensor, active: torch.Tensor,
              opt_error_init: torch.Tensor, with_rot_uncertainty: bool,
              fused: bool = False) -> InnerResult:
    """pts_rot (L, Nd, 3) pre-rotated data; rot_widths (L,); active (L,)
    bool; opt_error_init 0-d incumbent.

    fused=True runs the reference's two InnerBnB passes (ub with zero
    rotation uncertainty, lb with maxRotDis) as ONE search: each evaluated
    node yields both the plain ub (adoption candidate; best_err) and the
    uncertainty-adjusted ub/lb pair (pruning threshold / frontier key;
    lb_safe)."""
    L = pts_rot.shape[0]
    C = cfg.trans_capacity
    P = cfg.trans_pop
    assert P < C, "trans_pop must be < trans_capacity (sorted-slice pop)"
    dev = pts_rot.device
    f32 = torch.float32
    sse_thresh = torch.tensor(cfg.mse_margin, dtype=f32, device=dev) \
        * pair.inlier_f()

    mrd = rot_uncertainty(rot_widths, pair.norm_data) \
        if (with_rot_uncertainty or fused) else None

    root = torch.tensor([cfg.transMinX, cfg.transMinY, cfg.transMinZ,
                         cfg.transWidth], dtype=f32, device=dev)
    nodes0 = torch.zeros((L, C, 4), dtype=f32, device=dev)
    nodes0[:, 0] = root
    lbs0 = torch.full((L, C), INF, dtype=f32, device=dev)
    lbs0[:, 0] = 0.0
    inc = torch.ones((L,), dtype=f32, device=dev) * opt_error_init

    s = dict(
        nodes=nodes0, lbs=lbs0, opt_err=inc, thr=inc.clone(),
        best_node=torch.zeros((L, 4), dtype=f32, device=dev),
        ub_terms=torch.zeros((L, 3), dtype=f32, device=dev),
        min_dropped=torch.full((L,), INF, dtype=f32, device=dev),
        done=~active,
        it=0, evals=torch.zeros((), dtype=torch.int64, device=dev),
        geom_surv=torch.zeros((), dtype=torch.int64, device=dev),
        chem_corners=0,
    )
    if _chem_reuse_active(cfg):
        T = len(_chem_terms(cfg))
        cvals = torch.zeros((L, C, 8 * T), dtype=f32, device=dev)
        cvals[:, 0] = root_corner_values(pair, cfg, pts_rot)
        s["cvals"] = cvals

    def run(s, pts, mrd_s, stop_count: int):
        """Iterate while some lane is active (and, with stop_count > 0,
        while more lanes are active than the next stage's width)."""
        body = _make_inner_body(pair, cfg, pts, mrd_s, sse_thresh, fused)
        while s["it"] < cfg.inner_max_iters:
            n_active = int(torch.sum(~s["done"]))
            if n_active == 0 or (stop_count > 0 and n_active <= stop_count):
                break
            lanes, stats = body(s)
            s = dict(lanes, it=s["it"] + 1,
                     evals=s["evals"] + torch.sum(stats.evals),
                     geom_surv=s["geom_surv"] + torch.sum(stats.geom_surv),
                     chem_corners=s["chem_corners"]
                     + stats.corners_per_lane * pts.shape[0])
        return s

    stage_widths = [L]
    if cfg.lane_compaction and L >= 4:
        for w in (L // 2, max(L // 4, 1)):
            if w < stage_widths[-1]:
                stage_widths.append(w)

    s = run(s, pts_rot, mrd, stage_widths[1] if len(stage_widths) > 1 else 0)
    for i in range(1, len(stage_widths)):
        w = stage_widths[i]
        nxt = stage_widths[i + 1] if i + 1 < len(stage_widths) else 0
        # active lanes first (stable: in lane order)
        perm = torch.argsort(s["done"].to(torch.int32), stable=True)
        take = perm[:w]
        sub = {k: (v[take] if k in _PER_LANE else v) for k, v in s.items()}
        sub = run(sub, pts_rot[take], mrd[take] if mrd is not None else None,
                  nxt)
        merged = {}
        for k, v in s.items():
            if k in _PER_LANE:
                v = v.clone()
                v[take] = sub[k]
                merged[k] = v
            else:
                merged[k] = sub[k]
        s = merged

    # safe lower bound: lanes that did not finish also fold in the remaining
    # frontier min (they would have kept searching)
    rem_min = torch.amin(s["lbs"], dim=1)
    finished = s["done"]
    lb_safe = torch.minimum(s["thr"] if fused else s["opt_err"],
                            s["min_dropped"])
    lb_safe = torch.where(finished, lb_safe, torch.minimum(lb_safe, rem_min))
    return InnerResult(best_err=s["opt_err"], best_node=s["best_node"],
                       lb_safe=lb_safe, ub_terms=s["ub_terms"],
                       iters=s["it"], evals=s["evals"],
                       geom_surv=s["geom_surv"],
                       chem_corners=s["chem_corners"])


@functools.lru_cache(maxsize=8)
def _body_constants(dev: torch.device):
    """The body's index tables on `dev`, copied there once (the streams
    make a body every global iteration)."""
    return (torch.as_tensor(_CHILD_OFFSETS, dtype=torch.float32, device=dev),
            torch.as_tensor(_LATTICE_OFFSETS, dtype=torch.float32,
                            device=dev),
            torch.as_tensor(_ODD_LATTICE, device=dev),
            torch.as_tensor(_LAT_FROM_STORED, device=dev),
            torch.as_tensor(_CHILD_CORNER_TO_LATTICE, device=dev))


def _merge_sorted_keep(rest_lbs, rest_nodes, new_lbs, new_nodes, cap: int):
    """Merge the SORTED frontier remainder (R slots, ascending) with an
    UNSORTED block of children (B slots), keeping the `cap` lowest-lb
    entries: one sort of the B children, then each entry's rank from one
    (R, B) comparison matrix.  The order is the stable argsort's of
    concat([rest, new]) (ties: rest before children, children by index).
    NaN ranks as +inf but keeps its value, so a NaN lb stays infectious.

    rest_lbs (L,R), rest_nodes (L,R,K), new_lbs (L,B), new_nodes (L,B,K)
    -> (kept_lbs (L,cap), kept_nodes (L,cap,K), dropped_lbs (L,R+B-cap))."""
    L, R = rest_lbs.shape
    B = new_lbs.shape[1]
    K = rest_nodes.shape[-1]
    dev = rest_lbs.device
    kc = torch.where(torch.isnan(new_lbs), INF, new_lbs)
    kr = torch.where(torch.isnan(rest_lbs), INF, rest_lbs)
    co = torch.argsort(kc, dim=1, stable=True)               # (L,B)
    kcs = torch.gather(kc, 1, co)
    vals_s = torch.gather(new_lbs, 1, co)
    nodes_s = torch.gather(new_nodes, 1, co[..., None].expand(L, B, K))
    less = kcs[:, None, :] < kr[:, :, None]                  # (L,R,B)
    pos_r = torch.arange(R, device=dev)[None] + torch.sum(less, dim=2)
    pos_c = torch.arange(B, device=dev)[None] + (R - torch.sum(less, dim=1))
    m_lbs = torch.full((L, R + B), INF, dtype=rest_lbs.dtype, device=dev)
    m_lbs.scatter_(1, pos_r, rest_lbs)
    m_lbs.scatter_(1, pos_c, vals_s)
    m_nodes = torch.zeros((L, R + B, K), dtype=rest_nodes.dtype, device=dev)
    m_nodes.scatter_(1, pos_r[..., None].expand(L, R, K), rest_nodes)
    m_nodes.scatter_(1, pos_c[..., None].expand(L, B, K), nodes_s)
    return m_lbs[:, :cap], m_nodes[:, :cap], m_lbs[:, cap:]


class IterStats(NamedTuple):
    """What one body call did, per lane."""
    evals: torch.Tensor        # (L,) bound evaluations (valid children)
    geom_surv: torch.Tensor    # (L,) children surviving the geometric lb
    corners_per_lane: int      # chem corners evaluated for every lane


def _make_inner_body(pair, cfg, pts_rot, mrd, sse_thresh, fused):
    """The per-iteration inner-BnB body for a lane batch, on the full
    corner-lattice chem path: body(lanes) -> (lanes, IterStats), where
    `lanes` holds the per-lane fields (_PER_LANE) and the caller keeps the
    counters.  The ONE iteration of every engine: inner_bnb's (possibly
    compacted) batch of one pair, and the cross-pair streams' batches,
    whose lanes belong to several pairs: then `pair` is a LaneTables
    (bounds/evaluate.py) and sse_thresh holds one epsilon per lane."""
    L = pts_rot.shape[0]
    C = cfg.trans_capacity
    P = cfg.trans_pop
    dev = pts_rot.device
    f32 = torch.float32
    chem = _chem_active(cfg)
    two_phase = chem and cfg.chem_survivors > 0
    Ssel = min(cfg.chem_survivors, P * 8) if two_phase else 0
    reuse = _chem_reuse_active(cfg)
    terms_keys = _chem_terms(cfg)
    child_off, lattice_off, odd, lat_perm, c2l = _body_constants(dev)
    rows = torch.arange(L, device=dev)
    sse_lane = sse_thresh.reshape(-1)          # (1,) or (L,)
    sse_thresh = sse_thresh.reshape(-1, 1)     # against (L, P) pops

    def body(s):
        # SORTED-FRONTIER INVARIANT: lbs[l] is ascending (INF = empty), so
        # popping the P lowest-lb nodes is a slice
        lbs = s["lbs"]
        ref_err = s["thr"] if fused else s["opt_err"]
        min_lb = lbs[:, 0]
        done = s["done"] | torch.isinf(min_lb) \
            | (ref_err - min_lb < sse_lane)

        pop_lb = lbs[:, :P]
        parents = s["nodes"][:, :P]
        if reuse:
            parents_cv = s["cvals"][:, :P]
            rest_cv = s["cvals"][:, P:]
        expand = (~done[:, None]) & torch.isfinite(pop_lb) \
            & (ref_err[:, None] - pop_lb >= sse_thresh)
        # popped slots leave the frontier unconditionally
        rest_lbs = lbs[:, P:]
        rest_nodes = s["nodes"][:, P:]

        # expand children: (L,P,8,4)
        cw = parents[..., 3:4] / 2.0                         # (L,P,1)
        cxyz = parents[..., None, 0:3] \
            + child_off[None, None] * cw[..., None, :]
        cwidth = cw[..., None, :].expand(cxyz[..., :1].shape)
        children = torch.cat([cxyz, cwidth], dim=-1)         # (L,P,8,4)
        centers = (cxyz + cw[..., None, :] / 2.0).reshape(L, P * 8, 3)
        widths = cwidth.reshape(L, P * 8)

        if fused:
            ub, ubu, lb = geometric_bounds_fused(pair, cfg, pts_rot,
                                                 centers, widths, mrd)
        else:
            ub, lb = geometric_bounds(pair, cfg, pts_rot, centers, widths,
                                      mrd)
            ubu = None

        valid = expand[:, :, None].expand(L, P, 8).reshape(L, P * 8)
        ub = torch.where(valid, ub, INF)
        lb = torch.where(valid, lb, INF)
        if fused:
            ubu = torch.where(valid, ubu, INF)

        # children whose GEOMETRIC lb alone does not rule them out
        alive = valid & ~(lb >= s["opt_err"][:, None])

        child_cv = None
        best_ubu = None
        if chem and not two_phase:
            # chem corner terms for EVERY popped parent's shared 3x3x3
            # lattice (jly_goicp.cpp:429-550)
            corners = (parents[..., None, 0:3]
                       + lattice_off[None, None] * cw[..., None, :])
            if reuse:
                # the parent's own 8 cube corners ride in its frontier
                # payload; only the 19 new lattice points are evaluated
                corners_odd = corners[:, :, odd]             # (L,P,19,3)
                vals_odd = chem_corner_values(
                    pair, cfg, pts_rot, corners_odd.reshape(L, P * 19, 3))
                vals = {}
                for ti, k_ in enumerate(terms_keys):
                    both = torch.cat(
                        [parents_cv[..., ti * 8:(ti + 1) * 8],
                         vals_odd[k_].reshape(L, P, 19)], dim=-1)
                    vals[k_] = both[..., lat_perm]           # (L,P,27)
                n_corners = P * 19
                ub_add, lb_add, ub_t, cvd = chem_bounds_from_lattice(
                    cfg, vals, with_child_vals=True)
                child_cv = torch.cat(
                    [cvd[k_].reshape(L, P * 8, 8) for k_ in terms_keys],
                    dim=-1)                                  # (L,P*8,8T)
            else:
                vals = chem_corner_values(pair, cfg, pts_rot,
                                          corners.reshape(L, P * 27, 3))
                vals = {k: v.reshape(L, P, 27) for k, v in vals.items()}
                n_corners = P * 27
                ub_add, lb_add, ub_t = chem_bounds_from_lattice(cfg, vals)
            ub = ub + ub_add.reshape(L, P * 8)
            lb = lb + lb_add.reshape(L, P * 8)
            if fused:
                ubu = ubu + ub_add.reshape(L, P * 8)
            zero = torch.zeros((L, P, 8), dtype=f32, device=dev)
            incomp_t = ub_t.get("incomp", zero).reshape(L, P * 8)
            fpfh_t = ub_t.get("fpfh", zero).reshape(L, P * 8)
            terms = torch.stack([ub - incomp_t - fpfh_t, incomp_t, fpfh_t],
                                dim=-1)
        elif chem:
            # TWO-PHASE: chem corners only for the Ssel lowest-lb geometric
            # survivors of each lane, at the 8 corners of each, taken from
            # the parent's lattice (the same floats, so the same chem
            # values); results scatter back to the children's order.  A
            # survivor past the budget keeps its geometric lb (a valid
            # lower bound) and ub = inf (not adoptable this iteration).
            key = torch.where(alive, lb, INF)
            # a NaN bound is selected FIRST, so that it reaches adoption
            # and freezes the lane as on the lattice path
            key = torch.where(torch.isnan(lb), -INF, key)
            sel_idx = torch.argsort(key, dim=1, stable=True)[:, :Ssel]
            sel_ok = torch.gather(alive, 1, sel_idx)
            corners_lat = (parents[..., None, 0:3]
                           + lattice_off[None, None] * cw[..., None, :]
                           ).reshape(L, P * 27, 3)
            lat_idx = (sel_idx // 8 * 27)[..., None] + c2l[sel_idx % 8]
            corners_sel = torch.gather(
                corners_lat, 1,
                lat_idx.reshape(L, Ssel * 8, 1).expand(L, Ssel * 8, 3))
            vals = chem_corner_values(pair, cfg, pts_rot, corners_sel)
            ub_add = 0.0
            lb_add = 0.0
            ub_ts = {}
            for k_, reg in (("incomp", cfg.regularization),
                            ("fpfh", cfg.regularizationFPFH),
                            ("nbr", cfg.regularizationNeighbors)):
                if k_ not in vals:
                    continue
                v = vals[k_].reshape(L, Ssel, 8)
                vmax = torch.amax(v, dim=-1)
                vmin = torch.amin(v, dim=-1)
                ub_t_ = reg * vmax * vmax
                ub_add = ub_add + ub_t_
                lb_add = lb_add + reg * vmin * vmin
                ub_ts[k_] = ub_t_
            ub_sel = torch.where(sel_ok,
                                 torch.gather(ub, 1, sel_idx) + ub_add, INF)
            lb_sel = torch.where(sel_ok,
                                 torch.gather(lb, 1, sel_idx) + lb_add, INF)
            if fused:
                # the min over the selected survivors is the lattice path's
                # min over all children: the others have ubu >= lb_geom >=
                # opt_err >= thr and cannot lower it
                best_ubu = torch.amin(torch.where(
                    sel_ok, torch.gather(ubu, 1, sel_idx) + ub_add, INF),
                    dim=1)
            ub = torch.full_like(ub, INF).scatter_(1, sel_idx, ub_sel)
            lb = torch.where(alive, lb, INF).scatter_(1, sel_idx, lb_sel)
            zero = torch.zeros((L, Ssel), dtype=f32, device=dev)
            incomp_t = ub_ts.get("incomp", zero)
            fpfh_t = ub_ts.get("fpfh", zero)
            terms_sel = torch.stack(
                [ub_sel - incomp_t - fpfh_t, incomp_t, fpfh_t], dim=-1)
            terms = torch.zeros((L, P * 8, 3), dtype=f32, device=dev
                                ).scatter_(1, sel_idx[..., None].expand(
                                    L, Ssel, 3), terms_sel)
            n_corners = Ssel * 8
        else:
            terms = torch.stack([ub, torch.zeros_like(ub),
                                 torch.zeros_like(ub)], dim=-1)
            n_corners = 0
        if fused and best_ubu is None:
            best_ubu = torch.amin(ubu, dim=1)

        # adopt the best child ub per lane
        bc = torch.argmin(ub, dim=1)                         # (L,)
        best_ub = ub[rows, bc]
        improved = ~(best_ub >= s["opt_err"]) & ~done   # NaN-infectious <
        opt_err = torch.where(improved, best_ub, s["opt_err"])
        chosen = children.reshape(L, P * 8, 4)[rows, bc]
        best_node = torch.where(improved[:, None], chosen, s["best_node"])
        ub_terms = torch.where(improved[:, None], terms[rows, bc],
                               s["ub_terms"])

        # prune children vs the updated incumbent (fused: vs the
        # uncertainty threshold)
        if fused:
            thr = torch.minimum(s["thr"], torch.minimum(opt_err, best_ubu))
            thr = torch.where(done, s["thr"], thr)
            prune_ref = thr
        else:
            thr = s["thr"]
            prune_ref = opt_err
        lb = torch.where(lb >= prune_ref[:, None], INF, lb)

        # merge + keep the C lowest-lb nodes (one stable sort, or the rank
        # merge of sorted_merge, re-establishes the sorted-frontier
        # invariant); the corner-reuse payload rides
        child_payload = children.reshape(L, P * 8, 4)
        rest_payload = rest_nodes
        if reuse:
            child_payload = torch.cat([child_payload, child_cv], dim=-1)
            rest_payload = torch.cat([rest_nodes, rest_cv], dim=-1)
        if cfg.sorted_merge:
            keep_lbs, keep_payload, dropped = _merge_sorted_keep(
                rest_lbs, rest_payload, lb, child_payload, C)
        else:
            all_lbs = torch.cat([rest_lbs, lb], dim=1)       # (L, C+7P)
            all_nodes = torch.cat([rest_payload, child_payload], dim=1)
            order = torch.argsort(all_lbs, dim=1, stable=True)
            sorted_lbs = torch.gather(all_lbs, 1, order)
            keep_lbs = sorted_lbs[:, :C]
            keep_payload = torch.gather(
                all_nodes, 1,
                order[:, :C, None].expand(L, C, all_nodes.shape[-1]))
            dropped = sorted_lbs[:, C:]
        keep_nodes = keep_payload[..., :4]
        min_drop = torch.amin(torch.where(torch.isfinite(dropped), dropped,
                                          INF), dim=1)
        min_dropped = torch.minimum(s["min_dropped"],
                                    torch.where(done, INF, min_drop))

        keep_nodes = torch.where(done[:, None, None], s["nodes"], keep_nodes)
        keep_lbs = torch.where(done[:, None], s["lbs"], keep_lbs)

        out = dict(nodes=keep_nodes, lbs=keep_lbs, opt_err=opt_err, thr=thr,
                   best_node=best_node, ub_terms=ub_terms,
                   min_dropped=min_dropped, done=done)
        if reuse:
            out["cvals"] = torch.where(done[:, None, None], s["cvals"],
                                       keep_payload[..., 4:])
        return out, IterStats(evals=torch.sum(valid, dim=1),
                              geom_surv=torch.sum(alive, dim=1),
                              corners_per_lane=n_corners)

    return body
