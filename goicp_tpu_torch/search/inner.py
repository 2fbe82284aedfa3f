"""Inner translation BnB: lane-batched array frontier.

Port of goicp_tpu/search/inner.py.  Reference: GoICP::InnerBnB
(jly_goicp.cpp:286-579), a best-first priority queue over translation
subcubes.  Here L rotation lanes run their inner searches at once as a
leading batch axis; each lane's queue is a fixed-capacity frontier tensor,
kept sorted by lower bound.  Every iteration pops the P lowest-lb nodes,
evaluates all 8P children (bounds/evaluate.py), prunes and re-inserts with
one stable sort.  Epsilon-optimality under capacity overflow is kept by
folding the minimum lb of dropped nodes into the returned lower bound.

The JAX package's lax.while_loops run on the card here too: inner_run is
ONE launch of csrc/inner.cu (goicp_inner_run) that iterates until the
search ends, with no host read in between (a lane a thread-block cluster
that keeps the lane's state in shared memory; no grid barrier in modes
search and groups, an arrival count a global iteration in mode stream).
Its plain twin inner_run_plain is the Python loop that reads the
predicate on the host once per iteration, with the staged lane
compaction (L -> L/2 -> L/4: the still-active lanes gathered into a
narrower batch, which changes no lane's trajectory); the kernel leaves
the lanes in place and keeps only the compaction's trace in the
chem_corners counter.  Lanes that finished keep their state.

Two knobs change how an iteration does its work, never what it finds:
cfg.sorted_merge re-inserts the children by a rank merge against the
already-sorted frontier instead of one sort of both (the same order), and
cfg.chem_survivors > 0 evaluates the chem corner terms only for the lowest-
lb geometric survivors (two-phase bounds; the full budget 8 * trans_pop
gives the lattice path's trajectory).

One iteration is inner_step: on the card ONE launch of csrc/inner.cu
(goicp_inner_step), on the CPU inner_step_plain, the torch body
(_make_inner_body) at the same interface, which is also the kernel's
yardstick.  The engines run their loops through inner_loop: inner_bnb,
the batch engine's and the mesh's lane blocks a whole search in one run
(modes "search" and "groups"), the fused stream its global iterations
between two transitions ("stream"); the packed stream still steps
(inner_iteration).  kernel_carries says which configurations the kernels
compute: no chem term or the incompatibility count alone on the lattice
path (chem_survivors 0), at any pop and capacity whose arrays fit a
block; the others (two-phase chem, c-FPFH, neighbour terms) run the
plain loops on both devices.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.bounds import cuda_eval
from goicp_tpu_torch.bounds.evaluate import (_CHILD_CORNER_TO_LATTICE,
                                             _CHILD_OFFSETS,
                                             _LATTICE_OFFSETS, LaneTables,
                                             chem_bounds_from_lattice,
                                             chem_corner_values,
                                             geometric_bounds,
                                             geometric_bounds_fused,
                                             one_pair_tables, only_incomp,
                                             rot_uncertainty)
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.search.args import TransitionArgs, _call_block
from goicp_tpu_torch.utils.fp32 import _launch, _ptr, _stream, kernels

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

# iterations the torch body ran on CUDA tensors (none inside the step
# kernel's envelope; chip_smoke.py zeroes and reads it beside the launch
# counts)
body_on_card = {"iterations": 0}


def initial_lanes(pair, cfg: GoICPConfig, pts_rot: torch.Tensor,
                  active: torch.Tensor, opt_error_init) -> dict:
    """A fresh inner search's per-lane fields (_PER_LANE): the root node,
    the incumbent opt_error_init (0-d) in opt_err and thr, done = ~active,
    and under corner reuse the root's corner payload (`pair` a PairData,
    every lane of it)."""
    L = pts_rot.shape[0]
    C = cfg.trans_capacity
    dev = pts_rot.device
    f32 = torch.float32
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
        done=~active)
    if _chem_reuse_active(cfg):
        T = len(_chem_terms(cfg))
        cvals = torch.zeros((L, C, 8 * T), dtype=f32, device=dev)
        cvals[:, 0] = root_corner_values(pair, cfg, pts_rot)
        s["cvals"] = cvals
    return s


def inner_bnb(pair: PairData, cfg: GoICPConfig, pts_rot: torch.Tensor,
              rot_widths: torch.Tensor, active: torch.Tensor,
              opt_error_init: torch.Tensor, with_rot_uncertainty: bool,
              fused: bool = False, lanes0: dict | None = None,
              mrd: torch.Tensor | None = None,
              raw: bool = False, bufs=None):
    """pts_rot (L, Nd, 3) pre-rotated data; rot_widths (L,); active (L,)
    bool; opt_error_init 0-d incumbent.

    fused=True runs the reference's two InnerBnB passes (ub with zero
    rotation uncertainty, lb with maxRotDis) as ONE search: each evaluated
    node yields both the plain ub (adoption candidate; best_err) and the
    uncertainty-adjusted ub/lb pair (pruning threshold / frontier key;
    lb_safe).

    lanes0: the initial lanes (initial_lanes' fields, as the transition's
    pop writes them; None: built here); mrd (L, Nd): the rotation
    uncertainty of the lanes (None: computed here when needed).  raw=True
    leaves lb_safe to the caller (the transition's harvest) and returns
    (InnerResult with lb_safe None and the step's 0-d int32 evals and
    geom_surv, the final per-lane fields).

    On the card, for the configurations the kernel carries, the whole
    search is one launch of goicp_inner_run (inner_run, mode "search"):
    iters and chem_corners are then 0-d int32 tensors on the card and
    nothing is read on the host; elsewhere the loop of _search_plain, and
    they are ints.  bufs: the run's search/transition.py TransitionBuffers
    (see inner_run)."""
    C = cfg.trans_capacity
    P = cfg.trans_pop
    assert P < C, "trans_pop must be < trans_capacity (sorted-slice pop)"
    if mrd is None and (with_rot_uncertainty or fused):
        mrd = rot_uncertainty(rot_widths, pair.norm_data)
    if lanes0 is None:
        lanes0 = initial_lanes(pair, cfg, pts_rot, active, opt_error_init)
    if kernel_carries(cfg) and cuda_eval._route(pts_rot) == "cuda":
        r = inner_run(pair, cfg, lanes0, pts_rot, mrd, fused, "search",
                      bufs=bufs)
        s, cnt = r.lanes, r.counters
        iters, corners = r.iters, cnt["chem_corners"].reshape(())
    else:
        s, iters, corners, cnt = _search_plain(pair, cfg, lanes0, pts_rot,
                                               mrd, fused)
    if raw:
        return InnerResult(best_err=s["opt_err"], best_node=s["best_node"],
                           lb_safe=None, ub_terms=s["ub_terms"],
                           iters=iters, evals=cnt["evals"].reshape(()),
                           geom_surv=cnt["geom_surv"].reshape(()),
                           chem_corners=corners), s
    # safe lower bound: lanes that did not finish also fold in the remaining
    # frontier min (they would have kept searching)
    rem_min = torch.amin(s["lbs"], dim=1)
    finished = s["done"]
    lb_safe = torch.minimum(s["thr"] if fused else s["opt_err"],
                            s["min_dropped"])
    lb_safe = torch.where(finished, lb_safe, torch.minimum(lb_safe, rem_min))
    return InnerResult(best_err=s["opt_err"], best_node=s["best_node"],
                       lb_safe=lb_safe, ub_terms=s["ub_terms"],
                       iters=iters,
                       evals=cnt["evals"].reshape(()).to(torch.int64),
                       geom_surv=cnt["geom_surv"].reshape(()).to(torch.int64),
                       chem_corners=corners)


def _stage_widths(cfg: GoICPConfig, L: int) -> list:
    """The staged compaction's batch widths: L, then L/2 and L/4 (the
    JAX package's rule; none with lane_compaction 0 or L < 4)."""
    widths = [L]
    if cfg.lane_compaction and L >= 4:
        for w in (L // 2, max(L // 4, 1)):
            if w < widths[-1]:
                widths.append(w)
    return widths


def _search_plain(pair, cfg: GoICPConfig, lanes0: dict, pts_rot, mrd,
                  fused: bool):
    """inner_bnb's loop on the plain step (the JAX package's while_loops):
    iterate while some lane is active and it < inner_max_iters, with the
    staged lane compaction L -> L/2 -> L/4 (the active lanes gathered into
    a narrower batch once they fit it), one host read of the active-lane
    count an iteration.  -> (final lanes, it, chem_corners (ints), the
    evals and geom_surv counters ((1,) int32))."""
    L = pts_rot.shape[0]
    dev = pts_rot.device
    s = dict(
        lanes0,
        it=0, chem_corners=0,
        counters={k: torch.zeros((1,), dtype=torch.int32, device=dev)
                  for k in ("evals", "geom_surv")})

    def run(s, pair_s, pts, mrd_s, stop_count: int):
        """Iterate while some lane is active (and, with stop_count > 0,
        while more lanes are active than the next stage's width)."""
        n_active = int(torch.sum(~s["done"]))
        while s["it"] < cfg.inner_max_iters:
            if n_active == 0 or (stop_count > 0 and n_active <= stop_count):
                break
            lanes, cnt, stats = inner_step_plain(
                pair_s, cfg, {k: s[k] for k in _PER_LANE if k in s}, pts,
                mrd_s, fused, counters=s["counters"])
            s = dict(lanes, it=s["it"] + 1, counters=cnt,
                     chem_corners=s["chem_corners"]
                     + stats.corners_per_lane * pts.shape[0])
            n_active = int(stats.n_active)
        return s

    stage_widths = _stage_widths(cfg, L)
    s = run(s, pair, pts_rot, mrd,
            stage_widths[1] if len(stage_widths) > 1 else 0)
    for i in range(1, len(stage_widths)):
        w = stage_widths[i]
        nxt = stage_widths[i + 1] if i + 1 < len(stage_widths) else 0
        # active lanes first (stable: in lane order)
        perm = torch.argsort(s["done"].to(torch.int32), stable=True)
        take = perm[:w]
        sub = {k: (v[take] if k in _PER_LANE else v) for k, v in s.items()}
        sub_pair = pair
        if isinstance(pair, LaneTables) and pair.lane_pair is not None:
            # lanes of several pairs: each keeps its own
            sub_pair = pair._replace(lane_pair=pair.lane_pair[take])
        sub = run(sub, sub_pair, pts_rot[take],
                  mrd[take] if mrd is not None else None, nxt)
        merged = {}
        for k, v in s.items():
            if k in _PER_LANE:
                v = v.clone()
                v[take] = sub[k]
                merged[k] = v
            else:
                merged[k] = sub[k]
        s = merged
    return ({k: s[k] for k in _PER_LANE if k in s}, s["it"],
            s["chem_corners"], s["counters"])


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
        if pts_rot.is_cuda:
            body_on_card["iterations"] += 1
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


# ---------------------------------------------------------------------------
# the step: one iteration at the kernel's interface
# ---------------------------------------------------------------------------

_COUNTERS = ("it", "evals", "geom_surv", "chem_corners")


class StepStats(NamedTuple):
    """What one step did, per lane, beside the state it returns."""
    evals: torch.Tensor        # (L,) int32 bound evaluations of each lane
    geom_surv: torch.Tensor    # (L,) int32 children past the geometric lb
    n_active: torch.Tensor     # () int32 lanes not done after the step
    corners_per_lane: int      # chem corners evaluated for every lane


def kernel_carries(cfg: GoICPConfig) -> bool:
    """Does csrc/inner.cu compute the iteration of `cfg`?  Yes with no
    chem term or the incompatibility count alone on the lattice path; no
    for two-phase chem (chem_survivors > 0), c-FPFH and neighbour terms,
    which run inner_step_plain on either device."""
    return not _chem_active(cfg) or (only_incomp(cfg)
                                     and cfg.chem_survivors <= 0)


def _step_sse(pair, cfg: GoICPConfig) -> torch.Tensor:
    """The search epsilon as the body takes it: one value, or one per lane
    (a LaneTables' pair of each lane)."""
    if isinstance(pair, LaneTables):
        return pair.sse if pair.lane_pair is None \
            else pair.sse[pair.lane_pair.long()]
    return torch.tensor(cfg.mse_margin, dtype=torch.float32,
                        device=pair.device) * pair.inlier_f()


def inner_step_plain(pair, cfg: GoICPConfig, lanes: dict, pts, mrd,
                     fused: bool, live=None, groups: int = 1,
                     counters: dict | None = None):
    """One inner-BnB iteration in plain torch: the body of _make_inner_body
    at inner_step's interface (see there).  The CPU's route, the kernel's
    yardstick, and the route of the configurations the kernel does not
    carry."""
    lead = lanes["done"].shape
    L = lanes["done"].numel()
    G = L // groups
    flat = {k: v.reshape((L,) + v.shape[len(lead):])
            for k, v in lanes.items()}
    new, st = _make_inner_body(pair, cfg, pts, mrd, _step_sse(pair, cfg),
                               fused)(flat)
    evals = st.evals.to(torch.int32)
    surv = st.geom_surv.to(torch.int32)
    if live is not None:
        m = live.repeat_interleave(G)
        new = {k: torch.where(m.reshape((L,) + (1,) * (v.ndim - 1)), v,
                              flat[k]) for k, v in new.items()}
        evals = torch.where(m, evals, 0)
        surv = torch.where(m, surv, 0)
        lv = live.to(torch.int32)
    else:
        lv = torch.ones((groups,), dtype=torch.int32, device=pts.device)
    adds = dict(it=lv, evals=evals.reshape(groups, G).sum(dim=1),
                geom_surv=surv.reshape(groups, G).sum(dim=1),
                chem_corners=lv * (G * st.corners_per_lane))
    counters = counters or {}
    cnt = {k: (adds[k] + counters[k] if k in counters else adds[k]
               ).to(torch.int32) for k in _COUNTERS}
    out = {k: v.reshape(lanes[k].shape) for k, v in new.items()}
    return out, cnt, StepStats(
        evals=evals, geom_surv=surv,
        n_active=torch.sum(~new["done"]).to(torch.int32),
        corners_per_lane=st.corners_per_lane)


def _bad_input(items, dev):
    """Raise for the first of items (name, tensor, numel, dtype) that is not
    a contiguous tensor of that type and size on `dev`."""
    for name, x, n, dt in items:
        if x.device != dev or x.dtype != dt or x.numel() != n \
                or not x.is_contiguous():
            raise ValueError(
                f"inner_step: {name} must be a contiguous {dt} tensor of {n} "
                f"elements on {dev}; got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")


def _inputs_ok(items, idx: int) -> bool:
    return all(x.get_device() == idx and x.dtype == dt and x.numel() == n
               and x.is_contiguous() for _, x, n, dt in items)


def _lane_items(lanes: dict, pts, mrd, C: int, reuse: bool) -> list:
    """The lanes' fields, points and rotation uncertainty as a kernel of
    csrc/inner.cu reads them: (name, tensor, numel, dtype) for
    _inputs_ok / _bad_input."""
    f32 = torch.float32
    L, nd = lanes["done"].numel(), pts.shape[-2]
    items = [("pts", pts, L * nd * 3, f32),
             ("done", lanes["done"], L, torch.bool),
             ("nodes", lanes["nodes"], L * C * 4, f32),
             ("lbs", lanes["lbs"], L * C, f32),
             ("best_node", lanes["best_node"], L * 4, f32),
             ("ub_terms", lanes["ub_terms"], L * 3, f32),
             ("opt_err", lanes["opt_err"], L, f32),
             ("thr", lanes["thr"], L, f32),
             ("min_dropped", lanes["min_dropped"], L, f32)]
    if mrd is not None:
        items.append(("mrd", mrd, L * nd, f32))
    if reuse:
        items.append(("cvals", lanes["cvals"], L * C * 8, f32))
    return items


def _table_ptrs(t: LaneTables, key: tuple, chem: bool, dev,
                bufs: "StepBuffers | None") -> list:
    """The tables' pointers for goicp_inner_step, the tables checked; with
    a run's bufs only the first time this object comes with these sizes
    (the one-pair engines and the fused stream pass one object a run)."""
    if bufs is not None and bufs.tables[0] is t and bufs.tables[1] == key:
        return bufs.tables[2]
    L, nd, n_cells, W = key[:4]
    f32, i32 = torch.float32, torch.int32
    items = [("weights", t.weights, W * nd, f32),
             ("cell_coords", t.cell_coords, W * n_cells * 3, i32),
             ("nearest_cell", t.nearest_cell, W * t.size ** 3, i32),
             ("consts", t.consts, W * 5, f32), ("sse", t.sse, W, f32)]
    if t.trim_count is not None:
        items.append(("trim_count", t.trim_count, W, f32))
    if t.lane_pair is not None:
        items.append(("lane_pair", t.lane_pair, L, i32))
    if chem:
        items += [("cell_compat", t.cell_compat, W * n_cells * 9, f32),
                  ("prop_onehot", t.prop_onehot, W * nd * 9, f32),
                  ("data_mask", t.data_mask, W * nd, f32)]
    _bad_input(items, dev)
    ptrs = [t.weights.data_ptr(), t.cell_coords.data_ptr(),
            t.nearest_cell.data_ptr(), t.consts.data_ptr(),
            _ptr(t.trim_count), _ptr(t.cell_compat) if chem else None,
            _ptr(t.prop_onehot) if chem else None,
            _ptr(t.data_mask) if chem else None, _ptr(t.lane_pair),
            t.sse.data_ptr()]
    if bufs is not None:
        bufs.tables = (t, key, ptrs)
    return ptrs


class StepBuffers:
    """The outputs of a loop's inner steps, two sets used in turn: a step
    writes into a set that holds none of its inputs (no lane field and no
    counter in its memory), so a loop that feeds each step's output to the
    next allocates nothing after its second step.  Made per run: what a
    step returned stays valid until the step after next of the same run
    writes over it.  Also the run's checked tables and their pointers."""

    def __init__(self):
        self.sets: list = []
        self.tables: tuple = (None, None, None)


def _step_outputs(lanes: dict, inputs: list, L: int, C: int, reuse: bool,
                  groups: int, scratch: int, pts, bufs: StepBuffers | None):
    """(out lanes, counters, StepStats parts, output pointers) for one
    step: a set of bufs whose memory holds none of `inputs`, or a new one;
    the float fields and the kernel's scratch (`scratch` floats) packed in
    one allocation, the int32 stats, counters, active count and the
    launch's L + 1 tickets in another, done in a third."""
    key = (lanes["done"].shape, C, reuse, groups, scratch)
    if bufs is not None:
        held = {x.untyped_storage().data_ptr() for x in inputs}
        for k, st in bufs.sets:
            if k == key and held.isdisjoint(st[4]):
                return st[:4]
    sizes = (L * C * 4, L * C, L * C * 8 if reuse else 0, L, L, L * 4,
             L * 3, L, scratch)
    o = pts.new_empty(sum(sizes)).split(sizes)
    names = ("nodes", "lbs", "cvals", "opt_err", "thr", "best_node",
             "ub_terms", "min_dropped")
    out = {k: v.view(lanes[k].shape) for k, v in zip(names, o)
           if k in lanes}
    out["done"] = lanes["done"].new_empty(lanes["done"].shape)
    stats = torch.empty((2 * L + 4 * groups + 1 + L + 1,),
                        dtype=torch.int32, device=pts.device)
    cnt = dict(zip(_COUNTERS, stats[2 * L:2 * L + 4 * groups].view(
        4, groups)))
    parts = (stats[:L], stats[L:2 * L], stats[2 * L + 4 * groups])
    ptrs = [x.data_ptr() for x in o[:8]] + [
        out["done"].data_ptr(), stats.data_ptr(), o[8].data_ptr()]
    st = (out, cnt, parts, ptrs)
    if bufs is not None:
        mem = {x.untyped_storage().data_ptr() for x in (o[0], out["done"],
                                                        stats)}
        bufs.sets = (bufs.sets + [(key, st + (mem,))])[-2:]
    return st


def inner_step(pair, cfg: GoICPConfig, lanes: dict, pts, mrd, fused: bool,
               live=None, groups: int = 1, counters: dict | None = None,
               bufs: StepBuffers | None = None):
    """One inner-BnB iteration for a batch of lanes: on CUDA tensors one
    launch of csrc/inner.cu (goicp_inner_step) or a raise, on CPU tensors
    inner_step_plain.

    pair: a PairData (every lane of that pair; on the card its one-pair
    tables, evaluate.one_pair_tables) or a LaneTables (each lane the pair
    lane_pair says).  lanes: the per-lane fields of _PER_LANE with any
    leading shape (L lanes in all; contiguous on the card), pts (L, Nd, 3),
    mrd (L, Nd) or None (no rotation uncertainty).  The lanes fall in
    `groups` runs of L / groups: live (groups,) bool or None (all live)
    says which groups step, the others keep their state whole; counters
    (groups,) int32 among it / evals / geom_surv / chem_corners (missing:
    0) get the step's counts of each live group added.  Returns (new
    lanes, the four counters, StepStats); nothing given is written.  bufs:
    the run's StepBuffers, which the outputs then come from (on the card;
    the plain step allocates).  Raises on the card for a configuration
    the kernel does not carry (kernel_carries), shapes past
    cuda_eval.in_envelope, and a pop or capacity whose arrays do not fit
    a block (the launcher's refusal)."""
    if cuda_eval._route(pts) == "cpu":
        return inner_step_plain(pair, cfg, lanes, pts, mrd, fused, live,
                                groups, counters)
    t = pair if isinstance(pair, LaneTables) else one_pair_tables(pair, cfg)
    dev = pts.device
    done = lanes["done"]
    L = done.numel()
    nd = pts.shape[-2]
    W, n_cells = t.cell_coords.shape[:2]
    C = cfg.trans_capacity
    P = cfg.trans_pop
    chem = _chem_active(cfg)
    reuse = _chem_reuse_active(cfg)
    if not kernel_carries(cfg) or L % groups:
        raise ValueError("inner_step: the step kernel does not carry this "
                         "configuration (kernel_carries) or these groups")
    cuda_eval._check_envelope("inner_step", nd, n_cells, t.size)
    tab = _table_ptrs(t, (L, nd, n_cells, W), chem, dev, bufs)
    counters = counters or {}
    cnt_in = [counters.get(k) for k in _COUNTERS]
    items = _lane_items(lanes, pts, mrd, C, reuse)
    if live is not None:
        items.append(("live", live, groups, torch.bool))
    items += [(k, v, groups, torch.int32) for k, v in counters.items()]
    if not _inputs_ok(items, pts.get_device()):
        _bad_input(items, dev)
    Q = ((19 if reuse else 27) * P) if chem else 0
    out, cnt, parts, optrs = _step_outputs(
        lanes, [x for _, x, _, _ in items], L, C, reuse, groups,
        L * (24 * P + Q), pts, bufs)
    _launch(kernels.goicp_inner_step(
        pts.data_ptr(), _ptr(mrd), *tab, lanes["nodes"].data_ptr(),
        lanes["lbs"].data_ptr(), _ptr(lanes["cvals"]) if reuse else None,
        lanes["opt_err"].data_ptr(), lanes["thr"].data_ptr(),
        lanes["best_node"].data_ptr(), lanes["ub_terms"].data_ptr(),
        lanes["min_dropped"].data_ptr(), done.data_ptr(), _ptr(live),
        *(_ptr(c) for c in cnt_in), *optrs, L, C, P, L // groups, nd,
        n_cells, t.size, cfg.norm, int(fused), t.trim_k, int(reuse),
        int(cfg.sorted_merge), float(cfg.regularization), _stream(pts)),
        "inner_step")
    inner_step.launches += 1
    return dict(out), dict(cnt), StepStats(
        evals=parts[0], geom_surv=parts[1], n_active=parts[2],
        corners_per_lane=Q)


inner_step.launches = 0


def inner_iteration(pair, cfg: GoICPConfig, lanes: dict, pts, mrd,
                    fused: bool, live=None, groups: int = 1,
                    counters: dict | None = None,
                    bufs: StepBuffers | None = None):
    """The iteration every engine runs: inner_step for the configurations
    the kernel carries (kernel_carries; on the card one launch, whatever
    the shapes: those it cannot take raise), inner_step_plain for the
    others; the same arguments and results."""
    if kernel_carries(cfg):
        return inner_step(pair, cfg, lanes, pts, mrd, fused, live, groups,
                          counters, bufs)
    return inner_step_plain(pair, cfg, lanes, pts, mrd, fused, live, groups,
                            counters)


# ---------------------------------------------------------------------------
# the run: the iterations of a search in one launch
# ---------------------------------------------------------------------------

_RUN_MODES = {"search": 0, "groups": 1, "stream": 2}


class RunResult(NamedTuple):
    """What an inner run leaves: the lanes' fields after it, the four
    counters of each group after it, and the iterations it made."""
    lanes: dict
    counters: dict             # it, evals, geom_surv, chem_corners (groups,)
    iters: object              # an int (plain), a 0-d int32 tensor (kernel)
    clusters: object = None    # the kernel's grid in clusters (0-d int32)
    resident: object = None    # the lanes whose state stayed in a
                               # cluster's shared memory (0-d int32)


def _complete(cfg: GoICPConfig, lanes: dict, cnt: dict,
              groups: int) -> torch.Tensor:
    """(groups,) is each group's search complete: every lane done, or its
    `it` at inner_max_iters (fused_stream._inner_complete's rule)."""
    return torch.all(lanes["done"].reshape(groups, -1), dim=1) \
        | (cnt["it"] >= cfg.inner_max_iters)


def inner_run_plain(pair, cfg: GoICPConfig, lanes: dict, pts, mrd,
                    fused: bool, mode: str, live=None, watch=None,
                    once=None, groups: int = 1,
                    counters: dict | None = None, steps: int = 0,
                    step=None) -> RunResult:
    """The torch loops the run kernel replaces, at inner_run's interface
    (see there): mode "search" inner_bnb's loop with its staged compaction
    (_search_plain), "groups" the batch engine's loop (every group live
    until its search is complete), "stream" the fused stream's global
    iterations between two transitions; each step is inner_step_plain, or
    step(lanes, live, counters) -> (lanes, counters) where given (the
    fused stream's row-by-row body).  The CPU's route, the route of the
    configurations the kernel does not carry, and the kernel's yardstick;
    it reads the host after every iteration."""
    if mode == "search":
        new, it, corners, cnt = _search_plain(pair, cfg, lanes, pts, mrd,
                                              fused)
        dev = lanes["done"].device
        return RunResult(new, dict(
            it=torch.tensor([it], dtype=torch.int32, device=dev),
            evals=cnt["evals"], geom_surv=cnt["geom_surv"],
            chem_corners=torch.tensor([corners], dtype=torch.int32,
                                      device=dev)), it)
    if step is None:
        def step(lanes, live, cnt):
            new, cnt, _ = inner_step_plain(pair, cfg, lanes, pts, mrd, fused,
                                           live, groups, cnt)
            return new, cnt
    dev = lanes["done"].device
    cnt = {k: counters[k] if counters and k in counters
           else torch.zeros((groups,), dtype=torch.int32, device=dev)
           for k in _COUNTERS}
    n = 0
    if mode == "groups":
        while True:
            lv = ~_complete(cfg, lanes, cnt, groups)
            if not bool(torch.any(lv)):
                break
            lanes, cnt = step(lanes, lv, cnt)
            n += 1
    elif mode == "stream":
        if steps < 1:
            raise ValueError("inner_run: mode stream needs steps >= 1")
        while True:
            lanes, cnt = step(lanes, live, cnt)
            n += 1
            due = _complete(cfg, lanes, cnt, groups)
            if watch is not None:
                due = due & watch
            if n >= steps or bool(torch.any(due)) \
                    or (once is not None and bool(once)):
                break
    else:
        raise ValueError(f"inner_run: unknown mode {mode!r}")
    return RunResult(lanes, cnt, n)


_LANE_FIELDS = ("nodes", "lbs", "cvals", "opt_err", "thr", "best_node",
                "ub_terms", "min_dropped", "done")


def _run_outputs(lanes: dict, L: int, C: int, reuse: bool, groups: int,
                 pts) -> dict:
    """One allocation for a run: the output sets A (returned) and B, each
    the float fields packed and done, and the int32 words (counters
    (4, groups), info (4), the sync words (4), then L each of frozen,
    lane evals, lane survivors, lane steps and done iterations), zeroed
    here (on the card by a memset, not a kernel): the kernel leaves its
    sync words zero.  -> out (A's fields shaped as `lanes`), b (B's,
    flat), ints, and the RunResult's views of the words: cnt, iters,
    clusters, resident."""
    sizes = (L * C * 4, L * C, L * C * 8 if reuse else 0, L, L, L * 4,
             L * 3, L)
    F = sum(sizes)
    n_int = 4 * groups + 8 + 5 * L
    buf = pts.new_empty(2 * F + n_int + (2 * L + 3) // 4)
    ints = buf[2 * F:2 * F + n_int].view(torch.int32)
    if ints.is_cuda:      # a memset, no kernel launch
        _launch(kernels.goicp_zero_words(ints.data_ptr(), 4 * n_int,
                                         _stream(pts)), "inner_run zero")
    else:
        ints.zero_()
    dones = buf[2 * F + n_int:].view(torch.uint8)[:2 * L].view(torch.bool)
    sets = []
    for i in (0, 1):
        o = buf[i * F:(i + 1) * F].split(sizes)
        sets.append(dict(zip(_LANE_FIELDS, o), done=dones[i * L:(i + 1) * L]))
    lead = lanes["done"].shape
    shapes = dict(nodes=(C, 4), lbs=(C,), cvals=(C, 8), best_node=(4,),
                  ub_terms=(3,))
    out = {k: v.view(lead + shapes.get(k, ())) for k, v in sets[0].items()
           if k in lanes}
    return dict(out=out, b=sets[1], ints=ints,
                cnt=dict(zip(_COUNTERS, ints[:4 * groups].view(4, groups))),
                iters=ints[4 * groups], clusters=ints[4 * groups + 2],
                resident=ints[4 * groups + 3])


def _run_specs(L: int, C: int, nd: int, n_cells: int, S: int, W: int,
               groups: int, n_int: int) -> tuple:
    """(name, per-row shape, dtype, rows) of each of goicp_inner_run's
    pointer slots (csrc/inner.cu): the tables, the input lanes, live,
    watch, once, the counters in, output sets A and B, the int words."""
    f32, i32, b = torch.float32, torch.int32, torch.bool
    lane = (((C, 4), f32), ((C,), f32), ((C, 8), f32), ((), f32), ((), f32),
            ((4,), f32), ((3,), f32), ((), f32), ((), b))
    return ((("pts", (nd, 3), f32, L), ("mrd", (nd,), f32, L),
             ("weights", (nd,), f32, W),
             ("cell_coords", (n_cells, 3), i32, W),
             ("nearest_cell", (S ** 3,), i32, W), ("consts", (5,), f32, W),
             ("trim_count", (), f32, W),
             ("cell_compat", (n_cells, 9), f32, W),
             ("prop_onehot", (nd, 9), f32, W), ("data_mask", (nd,), f32, W),
             ("lane_pair", (), i32, L), ("sse", (), f32, W))
            + tuple((k, shp, dt, L) for k, (shp, dt) in zip(_LANE_FIELDS,
                                                            lane))
            + (("live", (), b, groups), ("watch", (), b, groups),
               ("once", (), b, 1))
            + tuple((k, (), i32, groups) for k in _COUNTERS)
            + tuple((f"{s}_{k}", shp, dt, L) for s in ("a", "b")
                    for k, (shp, dt) in zip(_LANE_FIELDS, lane))
            + (("ints", (n_int,), i32, 1),))


def inner_run(pair, cfg: GoICPConfig, lanes: dict, pts, mrd, fused: bool,
              mode: str, live=None, watch=None, once=None, groups: int = 1,
              counters: dict | None = None, steps: int = 0,
              bufs=None) -> RunResult:
    """The inner iterations of a whole search, or of a stretch of one: on
    CUDA tensors ONE launch of csrc/inner.cu (goicp_inner_run: a lane a
    thread-block cluster holding its state in shared memory, as many
    clusters as the card holds at once; no grid barrier in modes search
    and groups; no host read) or a raise, on CPU tensors inner_run_plain.

    pair, lanes, pts, mrd, fused: as inner_step's.  The lanes fall in
    `groups` runs of L / groups with counters (groups,) int32 among it /
    evals / geom_surv / chem_corners (missing: 0).  mode:
      "search": inner_bnb's loop, one group: while some lane is not done
        and it < inner_max_iters; chem_corners counts corners_per_lane x
        the width of the stage the staged compaction would be in;
      "groups": the batch engine's: while some group's search is not
        complete (every lane done or its it >= inner_max_iters), each
        group stepping until its own is;
      "stream": the fused stream's global iterations: the groups `live`
        (groups,) bool says (None: all) step, at least once, until a group
        `watch` (groups,) bool marks (None: all) has a complete search or
        `steps` iterations ran, or after one iteration when `once` (a 0-d
        bool) is true.
    An iteration counts only the groups that step in it.  Returns
    RunResult: the lanes' fields (new tensors, shaped as `lanes`), the
    counters after the run and the iterations it made (a 0-d int32 tensor
    on the card); nothing given is written.  bufs: the run's
    search/args.py TransitionBuffers: the outputs come from its two sets
    in turn (valid until the call after next), the call's argument block
    (search/args.py TransitionArgs: the tables, lanes and counters
    checked, re-checked only in the slots that hold a new tensor) is kept
    there, and the call is one kernel launch; None: new outputs (their
    sync words zeroed by a memset) and a block built for the call.  Raises
    on the card for a configuration the kernel does not carry
    (kernel_carries), shapes past cuda_eval.in_envelope, a wrong slot
    (naming it), a pop or capacity whose arrays do not fit a block, and a
    shape of which not one cluster fits the card: no path falls back to
    the step or the torch loop."""
    if cuda_eval._route(pts) == "cpu":
        return inner_run_plain(pair, cfg, lanes, pts, mrd, fused, mode,
                               live, watch, once, groups, counters, steps)
    t = pair if isinstance(pair, LaneTables) else one_pair_tables(pair, cfg)
    done = lanes["done"]
    L = done.numel()
    nd = pts.shape[-2]
    W, n_cells = t.cell_coords.shape[:2]
    C = cfg.trans_capacity
    chem = _chem_active(cfg)
    reuse = _chem_reuse_active(cfg)
    if not kernel_carries(cfg) or L % groups or mode not in _RUN_MODES:
        raise ValueError("inner_run: the run kernel does not carry this "
                         "configuration (kernel_carries), these groups or "
                         f"mode {mode!r}")
    if mode == "stream" and steps < 1:
        raise ValueError("inner_run: mode stream needs steps >= 1")
    cuda_eval._check_envelope("inner_run", nd, n_cells, t.size)
    counters = counters or {}
    widths = _stage_widths(cfg, L) + [0, 0] if mode == "search" else [0] * 3
    ints = (L, C, cfg.trans_pop, L // groups, nd, n_cells, t.size,
            cfg.norm, int(fused), t.trim_k, int(reuse),
            int(cfg.sorted_merge), _RUN_MODES[mode], cfg.inner_max_iters,
            int(steps), widths[1], widths[2])
    ins = (pts, mrd, t.weights, t.cell_coords, t.nearest_cell, t.consts,
           t.trim_count, t.cell_compat if chem else None,
           t.prop_onehot if chem else None, t.data_mask if chem else None,
           t.lane_pair, t.sse) \
        + tuple(lanes.get(k) if k != "cvals" or reuse else None
                for k in _LANE_FIELDS) \
        + (live, watch, once) + tuple(counters.get(k) for k in _COUNTERS)
    n_int = 4 * groups + 8 + 5 * L

    def outs(o):
        a = o["out"]
        return tuple(a.get(k) if k != "cvals" or reuse else None
                     for k in _LANE_FIELDS) \
            + tuple(o["b"][k] if k != "cvals" or reuse else None
                    for k in _LANE_FIELDS) + (o["ints"],)

    def make(tensors):
        return TransitionArgs(
            _run_specs(L, C, nd, n_cells, t.size, W, groups, n_int),
            tensors, len(ins), pts.device, ints, who="inner_run")

    # the block is kept for the shapes its slots were checked for; its
    # ints (the mode, a stream's steps left) are written each call
    o, blk = _call_block(
        bufs, ("inner_run", L, C, reuse, groups, done.shape, nd, n_cells,
               t.size, W),
        lambda: _run_outputs(lanes, L, C, reuse, groups, pts), ins, outs,
        make)
    blk.ints[:] = ints
    _launch(kernels.goicp_inner_run(
        blk.ptrs, len(blk.ptrs), blk.ints, len(blk.ints),
        float(cfg.regularization), _stream(pts)), "inner_run")
    inner_run.launches += 1
    return RunResult(o["out"], o["cnt"], o["iters"], o["clusters"],
                     o["resident"])


inner_run.launches = 0


def inner_loop(pair, cfg: GoICPConfig, lanes: dict, pts, mrd, fused: bool,
               mode: str, bufs=None, **kw) -> RunResult:
    """The inner loop every engine runs: inner_run for the configurations
    the kernel carries (kernel_carries; on the card one launch, whatever
    the shapes: those it cannot take raise), inner_run_plain for the
    others; the same arguments and results (bufs: inner_run's)."""
    if kernel_carries(cfg):
        return inner_run(pair, cfg, lanes, pts, mrd, fused, mode, bufs=bufs,
                         **kw)
    return inner_run_plain(pair, cfg, lanes, pts, mrd, fused, mode, **kw)
