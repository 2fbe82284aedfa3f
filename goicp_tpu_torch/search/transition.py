"""The outer-step transition of every engine that pops rotation cubes.

Port of what goicp_tpu/search/fused_stream.py::_harvest (:131) and
_advance (:177) do, vmapped over the window, and of the head and tail of
goicp_tpu/search/device_engine.py::_make_body (:259-412): the work JAX
leaves to XLA between one inner translation search and the next.  Three
functions, each for a batch of rows at once, each row reading its own
pair:

  harvest   a finished inner search's per-lane lower bound (lb_safe), the
            lanes' upper bounds, the first argmin lane's candidate (ub, R,
            t, terms), the incumbent min(opt_err, cand_ub), and the flags
            (improved, converged) that the one host read of a transition
            reads;
  event_head  the fused stream's transition event: each row's flags
            (finished, converged, complete), the rows it serves (the first
            K complete and not converged), their harvest and the event's
            words, which the stream reads in one copy (read_event).  On
            the card an inner run makes its harvest or its event head at
            its end (search/inner.py::inner_run(head=)), so that these
            launch alone only where no run came before (a chunk's first
            event) or none harvests (the two-pass engines, the sharded and
            the packed streams);
  advance   in three modes.  "pop" (register_device, the batch engine,
            the sharded engine): the convergence test and final_lb, the
            rot_batch parents and their 8 children each, the pi-ball
            test, rodrigues, the data rotated for every lane, the
            rotation uncertainty, under corner reuse the root corners'
            counts, and the fresh inner state the inner search starts
            from.  "adopt" (register_device's tail): the incumbent picked
            from the ICP, the BnB candidate or the old one, the children
            pruned and merged into the rest of the frontier with one
            stable sort, min_dropped, the kept entries pruned, the
            counters, the freeze of a converged row.  "both" (the
            streams): adopt on the whole frontier, then the next pop.

harvest_plain, event_head_plain and advance_plain are the torch code the
engines ran before, row by row (fused_stream._harvest / _advance,
device_engine._pop / _merge_children / _adopt, inner_bnb's lb_safe, the
stream's flags), at the kernel's interface: the CPU's route and the
kernel's yardstick.  harvest, event_head and advance route by
configuration (route): on a CUDA device the configurations the inner step
kernel carries (search/inner.py::kernel_carries) take csrc/transition.cu
(goicp_harvest and goicp_advance: one launch each in every mode, whatever
the number of rows); the others (two-phase chem,
c-FPFH, the neighbour term) keep the torch code on the card, counted in
`plain_on_card`.  No wrapper falls back on a failed build or launch.

Layouts.  A state holds W rows: the streams' window state (fused layout)
or a batch state, or one pair's state as a 1-row view.  `rows` (host
ints) names the rows a call serves; its outputs are either new tensors
with one row per served row, in order, or written into `out` at
`out_rows` (the streams write their window state in place: the kernel
stages a row before it writes it).  The harvest's and the refine block's
rows follow `rows`' order.  The pairs are a W-stacked PairData whose row
w is row w's pair; the kernel reads their data and point norms, and the
epsilon and K2's tables from the rows' LaneTables.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from goicp_tpu_torch.bounds import cuda_eval
from goicp_tpu_torch.bounds.evaluate import rot_uncertainty
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.geom.rotation import rodrigues
from goicp_tpu_torch.search import inner as inner_mod
from goicp_tpu_torch.search.args import (HARVEST_KEYS, REFINE_FIELDS,
                                         TransitionArgs, TransitionBuffers,
                                         _call_block, event_words)
from goicp_tpu_torch.search.inner import (_chem_reuse_active, _chem_terms,
                                          root_corner_values)
from goicp_tpu_torch.utils.fp32 import _launch, _stream, kernels, norm3, \
    rotate

SQRT3 = 3.0 ** 0.5
INF = float("inf")
_F32, _I32, _B = torch.float32, torch.int32, torch.bool

# rows the torch transition served on CUDA tensors (none inside the
# kernel's envelope; chip_smoke.py zeroes and reads it beside the launch
# counts)
plain_on_card = {"rows": 0}


def kernel_carries(cfg: GoICPConfig) -> bool:
    """Does csrc/transition.cu compute the transition of `cfg`?  When the
    inner step kernel computes its iteration and a frontier row is whole
    16-byte words (device_rot_capacity a multiple of 4), which the kernel
    stages and writes back with bulk copies."""
    return inner_mod.kernel_carries(cfg) and cfg.device_rot_capacity % 4 == 0


def route(cfg: GoICPConfig, x: torch.Tensor) -> str:
    """'kernel' or 'plain' for a transition of `cfg` on x's device."""
    return "kernel" if cuda_eval._route(x) == "cuda" and kernel_carries(cfg) \
        else "plain"


def _count_plain(x: torch.Tensor, n: int):
    if x.is_cuda:
        plain_on_card["rows"] += n


# ---------------------------------------------------------------------------
# harvest
# ---------------------------------------------------------------------------

def _harvest_row(src: dict, r: int, fused: bool, lb, lb_safe) -> dict:
    """One row: the inner search's finalize (inner_bnb's post-loop code,
    fused_stream._harvest) and the candidate."""
    ist = src["inner"]
    if lb_safe is None:
        lst = ist if lb is None else lb
        rem_min = torch.amin(lst["lbs"][r], dim=1)
        ls = torch.minimum(lst["thr"][r] if fused else lst["opt_err"][r],
                           lst["min_dropped"][r])
        ls = torch.where(lst["done"][r], ls, torch.minimum(ls, rem_min))
    else:
        ls = lb_safe[r]
    ubs = torch.where(src["active"][r], ist["opt_err"][r], INF)
    best_lane = torch.argmin(ubs)
    tn = ist["best_node"][r][best_lane]
    cand_ub = ubs[best_lane]
    opt = src["opt_err"][r]
    return dict(lb_safe=ls, ubs=ubs, cand_ub=cand_ub,
                cand_R=src["R_lanes"][r][best_lane],
                cand_t=tn[:3] + tn[3] / 2.0,
                cand_terms=ist["ub_terms"][r][best_lane],
                incumbent=torch.minimum(opt, cand_ub),
                improved=~(cand_ub >= opt))         # NaN-infectious <


_HARVEST_KEYS = HARVEST_KEYS[:-1]


def harvest_plain(src: dict, rows, fused: bool = True, lb=None,
                  lb_safe=None, conv=None, out=None) -> dict:
    """harvest in torch ops, row by row (see harvest); out: the outputs
    to write, row j for served row j (None: new tensors)."""
    rows = [int(r) for r in rows]
    _count_plain(src["opt_err"], len(rows))
    hs = [_harvest_row(src, r, fused, lb, lb_safe) for r in rows]
    new = {k: torch.stack([h[k] for h in hs]) for k in _HARVEST_KEYS}
    no = torch.zeros((), dtype=_B, device=src["opt_err"].device)
    new["flags"] = torch.stack([torch.stack(
        [h["improved"], no if conv is None else conv[r]])
        for h, r in zip(hs, rows)])
    if out is None:
        new["improved"] = new["flags"][:, 0]
        return new
    for k, v in new.items():
        out[k][:len(rows)] = v
    return out


def _harvest_out(n: int, L: int, dev) -> dict:
    out = _alloc(dict(lb_safe=((L,), _F32), ubs=((L,), _F32),
                      cand_ub=((), _F32), incumbent=((), _F32),
                      cand_R=((3, 3), _F32), cand_t=((3,), _F32),
                      cand_terms=((3,), _F32), flags=((2,), _B)), n, dev)
    out["improved"] = out["flags"][:, 0]
    return out


def harvest(cfg: GoICPConfig, src: dict, rows, fused: bool = True, lb=None,
            lb_safe=None, conv=None, bufs: "TransitionBuffers | None" = None
            ) -> dict:
    """A finished inner search's harvest for the rows `rows` of `src`:
    src["inner"] the lanes (W, L, ...) (lbs, thr, opt_err, min_dropped,
    done, best_node, ub_terms), src["active"] (W, L), src["R_lanes"] (W, L,
    3, 3), src["opt_err"] (W,).  fused: lb_safe from thr (else from
    opt_err: the two-pass lb pass); lb: the lb pass's lanes (two-pass;
    None: src["inner"]); lb_safe (W, L): given instead (the lanes gathered
    over a mesh); conv (W,) bool: copied into flags[:, 1].

    Returns, one row per served row: lb_safe, ubs (n, L), cand_ub,
    incumbent (n,), cand_R (n, 3, 3), cand_t, cand_terms (n, 3), flags
    (n, 2) bool [improved, converged] and improved (= flags[:, 0]).  bufs:
    the run's TransitionBuffers, whose two output sets for n rows the
    result then comes from, in turn (valid until the harvest after next
    of n rows), and which keeps the call's argument block; None: new
    outputs and a block built for the call.  On the card one launch of
    goicp_harvest (route), else harvest_plain."""
    rows = [int(r) for r in rows]
    n = len(rows)
    ist = src["inner"]
    lst = ist if lb is None else lb
    W, L = src["active"].shape
    dev = src["opt_err"].device
    given = lb_safe is not None
    C = 1 if given else lst["lbs"].shape[-1]
    ins = (None if given else lst["lbs"],
           None if given else lst["thr"] if fused else lst["opt_err"],
           None if given else lst["min_dropped"],
           None if given else lst["done"], lb_safe, ist["opt_err"],
           ist["best_node"], ist["ub_terms"], src["active"], src["R_lanes"],
           src["opt_err"], conv)
    kind = ("harvest", n, L, C, W)

    def alloc():
        return _harvest_out(n, L, dev)

    if route(cfg, src["opt_err"]) == "plain":
        out = None if bufs is None else bufs.take(kind, alloc, ins)[1]
        return harvest_plain(src, rows, fused, lb, lb_safe, conv, out)

    def specs():
        return tuple((k, shp, dt, W) for k, (shp, dt) in zip(_HARVEST_IN, (
            ((L, C), _F32), ((L,), _F32), ((L,), _F32), ((L,), _B),
            ((L,), _F32), ((L,), _F32), ((L, 4), _F32), ((L, 3), _F32),
            ((L,), _B), ((L, 3, 3), _F32), ((), _F32), ((), _B)))) + tuple(
            (k, shp, dt, n) for k, (shp, dt) in zip(HARVEST_KEYS, (
                ((L,), _F32), ((L,), _F32), ((), _F32), ((), _F32),
                ((3, 3), _F32), ((3,), _F32), ((3,), _F32), ((2,), _B))))

    out, blk = _call_block(
        bufs, kind, alloc, ins, lambda o: tuple(o[k] for k in HARVEST_KEYS),
        lambda t: TransitionArgs(specs(), t, len(_HARVEST_IN), dev, (L, C),
                                 n=n))
    blk.rows[:] = rows
    _launch(kernels.goicp_harvest(blk.ptrs, len(blk.ptrs), blk.ints, 2,
                                  blk.rows, n, _stream(src["opt_err"])),
            "harvest")
    harvest.launches += 1
    return out


harvest.launches = 0

_HARVEST_IN = ("lbs", "ref", "lmin_drop", "ldone", "lb_in", "ub_err",
               "best_node", "ub_terms", "active", "R_lanes", "opt_err",
               "conv")


# ---------------------------------------------------------------------------
# the fused stream's event head
# ---------------------------------------------------------------------------

def event_head_plain(cfg: GoICPConfig, s: dict, K: int, n_iters=0,
                     fin0=None) -> dict:
    """event_head in torch ops (see there): the flags as fused_run_chunk
    stacked them, the served rows as np.nonzero(complete & ~converged)[:K]
    picked them (a stable argsort puts the served rows first in index
    order), and harvest_plain's row for each served row.  On the CPU the
    number served costs no host read: the harvest's outputs then hold the
    served rows only (none where no row is served).  On the card it would
    be a read, so the harvest fills all K slots, those past the rows
    served from some other row (their values are not the kernel's, and
    no one reads them)."""
    from goicp_tpu_torch.search.fused_stream import _inner_complete
    dev = s["opt_err"].device
    conv = s["converged"]
    finished = conv | (s["it"] >= cfg.max_outer_steps)
    complete = _inner_complete(cfg, s)
    cand = complete & ~conv
    served = cand & (torch.cumsum(cand.to(_I32), 0) <= K)
    n = torch.sum(served.to(_I32))
    order = torch.argsort((~served).to(_I32), stable=True)[:K]
    m = K if conv.is_cuda else int(n)
    _count_plain(s["opt_err"], m)
    hs = [_harvest_row(s, order[j], True, None, None) for j in range(m)]
    if hs:
        h = {k: torch.stack([x[k] for x in hs]) for k in _HARVEST_KEYS}
        h["flags"] = torch.stack([torch.stack([x["improved"],
                                               conv[order[j]]])
                                  for j, x in enumerate(hs)])
        h["improved"] = h["flags"][:, 0]
    else:
        h = _harvest_out(0, s["active"].shape[1], dev)
    j = torch.arange(K, device=dev)
    improved = torch.zeros((K,), dtype=_B, device=dev)
    improved[:m] = h["improved"]
    words = torch.cat([
        finished.to(_I32), conv.to(_I32), complete.to(_I32), n.reshape(1),
        torch.where(j < n, order, -1).to(_I32),
        torch.where(j < n, improved, False).to(_I32),
        torch.as_tensor(n_iters, device=dev).to(_I32).reshape(1)])
    if fin0 is not None:
        fin0.copy_(finished)
    return dict(h=h, words=words)


def _event_out(W: int, K: int, L: int, dev) -> dict:
    return dict(h=_harvest_out(K, L, dev),
                words=torch.empty((event_words(W, K),), dtype=_I32,
                                  device=dev))


_EVENT_IN = ("it", "inner_it")
_EVENT_OUT = ("words", "fin0")


def event_head(cfg: GoICPConfig, s: dict, K: int, n_iters=0, fin0=None,
               bufs: TransitionBuffers | None = None) -> dict:
    """The fused stream's transition event on the window state `s` (W rows:
    converged, it, active, R_lanes, opt_err, and the lanes and counters of
    s["inner"]): each row's flags finished = converged | it >=
    max_outer_steps, converged and complete (every lane done or the inner
    it at inner_max_iters); the rows served, complete & ~converged, the
    first K in index order; their harvest (harvest's fields, fused: lb_safe
    from thr, flags[:, 1] the row's converged); and the event's words
    (event_words: the flags, the rows served, the rows, their improved
    flags, n_iters, the global iterations of the run before).  fin0 (W,)
    bool: written with finished where given.  Returns dict(h: the
    harvest's outputs for K rows, the served rows first, words: (words,)
    int32); read it with read_event.  bufs: the run's TransitionBuffers
    (the outputs from its two sets in turn, and the call's argument
    block).  On the card one launch of goicp_harvest's event mode (one
    block; csrc/harvest_body.cuh's event_head, the one an inner run makes
    at its end), else event_head_plain."""
    if route(cfg, s["opt_err"]) == "plain":
        return event_head_plain(cfg, s, K, n_iters, fin0)
    ist = s["inner"]
    W, L = s["active"].shape
    C = ist["lbs"].shape[-1]
    dev = s["opt_err"].device
    nw = event_words(W, K)
    ins = (ist["lbs"], ist["thr"], ist["min_dropped"], ist["done"], None,
           ist["opt_err"], ist["best_node"], ist["ub_terms"], s["active"],
           s["R_lanes"], s["opt_err"], s["converged"])
    ints = (L, C, W, K, cfg.max_outer_steps, cfg.inner_max_iters,
            int(n_iters))

    def outs(o):
        return tuple(o["h"][k] for k in HARVEST_KEYS) + (
            s["it"], ist["it"], o["words"], fin0)

    def specs():
        return tuple((k, shp, dt, W) for k, (shp, dt) in zip(_HARVEST_IN, (
            ((L, C), _F32), ((L,), _F32), ((L,), _F32), ((L,), _B),
            ((L,), _F32), ((L,), _F32), ((L, 4), _F32), ((L, 3), _F32),
            ((L,), _B), ((L, 3, 3), _F32), ((), _F32), ((), _B)))) + tuple(
            (k, shp, dt, K) for k, (shp, dt) in zip(HARVEST_KEYS, (
                ((L,), _F32), ((L,), _F32), ((), _F32), ((), _F32),
                ((3, 3), _F32), ((3,), _F32), ((3,), _F32), ((2,), _B)))) + (
            ("it", (), _I32, W), ("inner_it", (), _I32, W),
            ("words", (nw,), _I32, 1), ("fin0", (), _B, W))

    out, blk = _call_block(
        bufs, ("event", W, K, L, C), lambda: _event_out(W, K, L, dev), ins,
        outs, lambda t: TransitionArgs(specs(), t, len(_HARVEST_IN), dev,
                                       ints))
    blk.ints[:] = ints
    _launch(kernels.goicp_harvest(blk.ptrs, len(blk.ptrs), blk.ints,
                                  len(ints), blk.rows, 0,
                                  _stream(s["opt_err"])), "event head")
    harvest.launches += 1
    return out


class Event(NamedTuple):
    """An event's words as the host reads them (read_event)."""
    finished: np.ndarray       # (W,) bool
    converged: np.ndarray      # (W,) bool
    complete: np.ndarray       # (W,) bool
    rows: list                 # the rows served, in index order
    improved: np.ndarray       # (len(rows),) bool
    n_iters: int               # the global iterations of the run before


def read_event(ev: dict, W: int, K: int,
               bufs: TransitionBuffers | None = None) -> Event:
    """The host's one read of an event (event_head's or an inner run's at
    its end): its words, in one copy (on the card into the pinned host
    words bufs keeps; the copy waits for the stream's work, no device
    synchronize)."""
    w = ev["words"]
    if w.is_cuda:
        host = bufs.host_words(w) if bufs is not None else torch.empty(
            w.shape, dtype=w.dtype, pin_memory=True)
        host.copy_(w)
        a = host.numpy()
    else:
        a = w.numpy()
    f = a[:3 * W].reshape(3, W) != 0
    n = int(a[3 * W])
    return Event(finished=f[0], converged=f[1], complete=f[2],
                 rows=[int(r) for r in a[3 * W + 1:3 * W + 1 + n]],
                 improved=a[3 * W + 1 + K:3 * W + 1 + K + n] != 0,
                 n_iters=int(a[3 * W + 1 + 2 * K]))


# ---------------------------------------------------------------------------
# the refine block's rows
# ---------------------------------------------------------------------------

# the engines' refinements write the block into a run's record
# (search/args.py::RefineRecord, search/pick.py: csrc/score.cu on the
# card); these two make and write one in torch ops
_REFINE = REFINE_FIELDS


def reset_refine(r: dict) -> None:
    """Every row of a refine block to the dummy of a row that did not
    refine (identity, 0, inf, 0, 0, 0, do_icp False), in place."""
    r["icp_R"].copy_(torch.eye(3, dtype=_F32, device=r["icp_R"].device))
    for k in ("icp_t", "icp_terms", "icp_incomp", "bnb_comp", "do_icp"):
        r[k].zero_()
    r["icp_err"].fill_(INF)


def dummy_refine_rows(n: int, device) -> dict:
    """The refine block's outputs for n rows, every row the dummy of a row
    that did not refine: the caller writes the rows that refined with
    set_refine."""
    r = {k: torch.empty((n,) + shape, dtype=dt, device=device)
         for k, shape, dt in _REFINE}
    reset_refine(r)
    return r


def set_refine(r: dict, j: int, ref: dict) -> None:
    """Row j of dummy_refine_rows' r <- one row's refine block (icp_R, icp_t,
    icp_err, icp_terms, icp_incomp, bnb_comp), do_icp set."""
    for k, _, _ in _REFINE[:-1]:
        r[k][j] = ref[k]
    r["do_icp"][j] = True


# ---------------------------------------------------------------------------
# advance: the torch code, row by row
# ---------------------------------------------------------------------------

def _child_off(dev) -> torch.Tensor:
    return torch.tensor([[j & 1, (j >> 1) & 1, (j >> 2) & 1]
                         for j in range(8)], dtype=_F32, device=dev)


def _sse(pair, cfg: GoICPConfig) -> torch.Tensor:
    return torch.tensor(cfg.mse_margin, dtype=_F32, device=pair.device) \
        * pair.inlier_f()


def _inner_init(cfg: GoICPConfig, L: int, opt_err: torch.Tensor,
                root_cv=None) -> dict:
    """Fresh inner-search state for one pair's L rotation lanes (the
    per-lane translation frontier of search/inner.py, as carried state).
    root_cv (L, 8*T): the root node's corner-reuse chem payload (required
    for a REAL search when cfg.chem_reuse; the dummy init passes None)."""
    dev = opt_err.device
    C = cfg.trans_capacity
    root = torch.tensor([cfg.transMinX, cfg.transMinY, cfg.transMinZ,
                         cfg.transWidth], dtype=_F32, device=dev)
    nodes = torch.zeros((L, C, 4), dtype=_F32, device=dev)
    nodes[:, 0] = root
    lbs = torch.full((L, C), INF, dtype=_F32, device=dev)
    lbs[:, 0] = 0.0
    inc = opt_err.to(_F32).expand(L).clone()

    def i32():
        return torch.tensor(0, dtype=_I32, device=dev)
    st = dict(
        nodes=nodes, lbs=lbs, opt_err=inc, thr=inc.clone(),
        best_node=torch.zeros((L, 4), dtype=_F32, device=dev),
        ub_terms=torch.zeros((L, 3), dtype=_F32, device=dev),
        min_dropped=torch.full((L,), INF, dtype=_F32, device=dev),
        done=torch.zeros((L,), dtype=_B, device=dev),
        it=i32(), evals=i32(), geom_surv=i32(), chem_corners=i32(),
    )
    if _chem_reuse_active(cfg):
        cv = torch.zeros((L, C, 8 * len(_chem_terms(cfg))), dtype=_F32,
                         device=dev)
        if root_cv is not None:
            cv[:, 0] = root_cv
        st["cvals"] = cv
    return st


def _pop_row(pair, cfg: GoICPConfig, s: dict, min_lb=None) -> dict:
    """The head of an outer step (device_engine._pop): pop the rot_batch
    lowest-lb rotation nodes (sorted frontier), test convergence, expand 8
    children each with the pi-ball filter, rotate the data for every child
    lane, its rotation uncertainty, and the inner search's fresh lanes
    (inner.initial_lanes).  min_lb: the lb convergence is tested on (None:
    the frontier's own minimum)."""
    dev = pair.device
    Pr = cfg.rot_batch
    L = Pr * 8
    sse = _sse(pair, cfg)
    child_off = _child_off(dev)
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
    mrd = rot_uncertainty(widths, pair.norm_data)
    lanes = inner_mod.initial_lanes(pair, cfg, pts, active, s["opt_err"])
    return dict(converged=converged, final_lb=final_lb, pop_lb=pop_lb,
                expand=expand, child_nodes=child_nodes, widths=widths,
                active=active, R_lanes=R_lanes, pts=pts, mrd=mrd,
                lanes=lanes)


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


def _adopt_row(cfg: GoICPConfig, s: dict, p: dict, cand: dict, icp: dict,
               bnb_improved, icp_improved, lb_safe, work: dict) -> dict:
    """The tail of an outer step (device_engine._adopt): adopt the ICP
    result when it beats the candidate, else the candidate; prune and
    merge the children into the frontier; freeze a converged search."""
    dev = s["opt_err"].device

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

    out = dict(
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
    if "it" in s:
        out["it"] = s["it"] + 1
    return out


def _advance_row(pair, cfg: GoICPConfig, s: dict, h: dict, r: dict,
                 bnb_improved, icp_improved) -> dict:
    """Per-pair adopt + prune/merge + pop + rotate + fresh inner state, for
    a row that transitions (fused_stream._advance; device_engine._make_body's
    tail).  Returns the row's new state."""
    dev = pair.device
    Pr = cfg.rot_batch
    L = Pr * 8
    Cr = cfg.device_rot_capacity
    sse = _sse(pair, cfg)
    child_off = _child_off(dev)
    ist = s["inner"]
    lb_safe = h["lb_safe"]
    cand_ub = h["cand_ub"]

    def adopt(icp_v, bnb_v, old_v):
        return torch.where(icp_improved, icp_v,
                           torch.where(bnb_improved, bnb_v, old_v))

    opt_err = adopt(r["icp_err"], cand_ub, s["opt_err"])
    opt_R = adopt(r["icp_R"], h["cand_R"], s["opt_R"])
    opt_t = adopt(r["icp_t"], h["cand_t"], s["opt_t"])
    comp = adopt(r["icp_incomp"], r["bnb_comp"], s["comp"]).to(_I32)
    terms = adopt(r["icp_terms"], h["cand_terms"], s["terms"])
    last_icp = icp_improved | (~bnb_improved & s["last_icp"])

    # ---- prune + merge children into the (sorted) rotation frontier ----
    lbs_new = torch.where(s["active"] & (lb_safe < opt_err), lb_safe, INF)
    all_lbs = torch.cat([s["fr_lbs"], lbs_new])
    all_nodes = torch.cat([s["fr_nodes"], s["child_nodes"]])
    order = torch.argsort(all_lbs, stable=True)
    keep_lbs = all_lbs[order[:Cr]]
    keep_nodes = all_nodes[order[:Cr]]
    dropped = all_lbs[order[Cr:]]
    min_drop = torch.amin(torch.where(torch.isfinite(dropped), dropped, INF))
    keep_lbs = torch.where(keep_lbs >= opt_err, INF, keep_lbs)

    # ---- convergence check + pop the next Pr parents ----
    pop_lb = keep_lbs[:Pr]
    min_lb = pop_lb[0]
    converged = torch.isinf(min_lb) | (opt_err - min_lb <= sse) \
        | torch.isnan(opt_err)    # numeric guard: freeze on NaN incumbent
    final_lb = torch.where(converged & ~s["converged"], min_lb,
                           s["final_lb"])
    parents = keep_nodes[:Pr]
    rest_lbs = torch.cat([keep_lbs[Pr:],
                          torch.full((Pr,), INF, dtype=_F32, device=dev)])
    rest_nodes = torch.cat([keep_nodes[Pr:],
                            torch.zeros((Pr, 4), dtype=_F32, device=dev)])
    expand = torch.isfinite(pop_lb) & (opt_err - pop_lb > sse) & ~converged

    cw = parents[:, 3:4] / 2.0
    cxyz = parents[:, None, 0:3] + child_off[None] * cw[:, None]
    centers = (cxyz + cw[:, None] / 2.0).reshape(L, 3)
    widths = cw[:, None].expand(Pr, 8, 1).reshape(L)
    child_nodes = torch.cat([cxyz.reshape(L, 3), widths[:, None]], dim=1)
    inside = (norm3(centers)
              - SQRT3 * widths / 2.0) <= math.pi
    active = inside & torch.repeat_interleave(expand, 8)
    R_lanes = rodrigues(centers)
    pts = rotate(R_lanes, pair.data)
    mrd = rot_uncertainty(widths, pair.norm_data)
    root_cv = root_corner_values(pair, cfg, pts) \
        if _chem_reuse_active(cfg) else None
    inner_new = _inner_init(cfg, L, opt_err, root_cv=root_cv)
    inner_new["done"] = ~active | converged

    return dict(
        fr_nodes=rest_nodes, fr_lbs=rest_lbs,
        opt_err=opt_err, opt_R=opt_R, opt_t=opt_t, comp=comp, terms=terms,
        last_icp=last_icp,
        min_dropped=torch.minimum(s["min_dropped"], min_drop),
        # one `it` per pop performed — each transition pops exactly once,
        # matching device_engine's one-increment-per-body (including its
        # final convergence-detecting pop)
        it=s["it"] + 1,
        evals=s["evals"] + ist["evals"],
        inner_it=s["inner_it"] + ist["it"],
        icp_runs=s["icp_runs"] + (bnb_improved.to(_I32)
                                  if cfg.icp_on_improve else 1),
        geom_surv=s["geom_surv"] + ist["geom_surv"],
        chem_corners=s["chem_corners"] + ist["chem_corners"],
        converged=s["converged"] | converged,
        final_lb=final_lb,
        inner=inner_new,
        pts_rot=pts, mrd=mrd, widths=widths, active=active,
        child_nodes=child_nodes, R_lanes=R_lanes,
    )


def _row_of(d: dict, r: int) -> dict:
    """Row r of every tensor of a (nested) state; other values as they
    are (register_device's Python int `it`)."""
    return {k: _row_of(v, r) if isinstance(v, dict)
            else v[r] if isinstance(v, torch.Tensor) else v
            for k, v in d.items()}


def _emit(rows_out: list, out, out_rows):
    """The rows' new values: stacked into new tensors (out None), or
    written into out at out_rows (then out is returned)."""
    if out is None:
        def stack(*vs):
            if isinstance(vs[0], dict):
                return {k: stack(*(v[k] for v in vs)) for k in vs[0]}
            return torch.stack(vs)
        return stack(*rows_out)

    def write(dst, src, o):
        for k, v in src.items():
            if isinstance(v, dict):
                write(dst[k], v, o)
            elif k in dst:
                dst[k][o] = v
    for new, o in zip(rows_out, out_rows):
        write(out, new, o)
    return out


def advance_plain(mode: str, cfg: GoICPConfig, pairs, s: dict, rows, *,
                  h=None, r=None, p=None, work=None, min_lb=None, out=None,
                  out_rows=None) -> dict:
    """advance in torch ops, row by row (see advance)."""
    from goicp_tpu_torch.search.fused_stream import _pair_row
    rows = [int(w) for w in rows]
    out_rows = rows if out_rows is None and out is not None else out_rows
    _count_plain(s["opt_err"], len(rows))
    new = []
    for j, w in enumerate(rows):
        hj = None if h is None else {k: v[j] for k, v in h.items()}
        if mode == "pop":
            new.append(_pop_row(_pair_row(pairs, w), cfg, _row_of(s, w),
                                None if min_lb is None else min_lb[j]))
            continue
        rj = _row_of(r, j) if r is not None \
            else _row_of(dummy_refine_rows(1, s["opt_err"].device), 0)
        icp_improved = rj["do_icp"] & ~(rj["icp_err"] >= hj["incumbent"])
        if mode == "both":
            new.append(_advance_row(_pair_row(pairs, w), cfg, _row_of(s, w),
                                    hj, rj, hj["improved"], icp_improved))
            continue
        st = {k: v[w] for k, v in s.items() if k != "it" or
              isinstance(v, torch.Tensor)}
        pj = dict(fr_lbs=s["fr_lbs"][w, cfg.rot_batch:],
                  fr_nodes=s["fr_nodes"][w, cfg.rot_batch:],
                  **{k: p[k][w] for k in ("active", "child_nodes",
                                          "converged", "final_lb")})
        wk = {k: (v[w] if isinstance(v, torch.Tensor) and v.dim() else v)
              for k, v in work.items()}
        cand = dict(ub=hj["cand_ub"], R=hj["cand_R"], t=hj["cand_t"],
                    terms=hj["cand_terms"])
        icp = dict(R=rj["icp_R"], t=rj["icp_t"], err=rj["icp_err"],
                   terms=rj["icp_terms"], incomp=rj["icp_incomp"],
                   bnb_comp=rj["bnb_comp"])
        new.append(_adopt_row(cfg, st, pj, cand, icp, hj["improved"],
                              icp_improved, hj["lb_safe"], wk))
    return _emit(new, out, out_rows)


# ---------------------------------------------------------------------------
# advance: the kernel
# ---------------------------------------------------------------------------

# goicp_advance's pointer slots, in csrc/transition.cu's AdvanceSlot order:
# _ADV_ROWS, _ADV_SERVED, _ADV_PAIRS, then _ADV_OUT
_NO = "\0"     # a key no dict holds: its slot is None
_IT = 9        # `it` among _ADV_STATE
_INNER_COUNTERS = ("evals", "it", "geom_surv", "chem_corners")
_ADV_STATE = ("fr_nodes", "fr_lbs", "opt_err", "opt_R", "opt_t", "comp",
              "terms", "last_icp", "min_dropped", "it", "evals", "inner_it",
              "icp_runs", "geom_surv", "chem_corners", "converged",
              "final_lb")
_ADV_ROWS = _ADV_STATE + (          # W rows, read at the served rows
    "active", "child_nodes", "p_conv", "p_final",
    "w_evals", "w_it", "w_surv", "w_corners")
_ADV_SERVED = (                      # one row per served row
    "lb_safe", "cand_ub", "incumbent", "cand_R", "cand_t", "cand_terms",
    "flags",
    "icp_R", "icp_t", "icp_err", "icp_terms", "icp_incomp", "bnb_comp",
    "do_icp", "min_lb")
_ADV_PAIRS = ("data", "norm_data", "sse", "cell_compat", "prop_onehot",
              "data_mask", "nearest_cell", "consts")      # W rows
_ADV_OUT = tuple("o_" + k for k in _ADV_STATE) + (
    "o_pop_lb", "o_expand", "o_child_nodes", "o_widths", "o_active",
    "o_R_lanes", "o_pts", "o_mrd", "o_nodes", "o_lbs", "o_iopt", "o_ithr",
    "o_best_node", "o_ub_terms", "o_imin_dropped", "o_done", "o_cvals",
    "o_iit", "o_ievals", "o_isurv", "o_icorners")
_MODES = {"both": 0, "pop": 1, "adopt": 2}
_WORK = ("evals", "iters", "geom_surv", "chem_corners")
_REFINE_KEYS = tuple(k for k, _, _ in _REFINE)
# the fields each mode's slots are read from (_NO: the slot is None)
_STATE_READS = dict(both=_ADV_STATE, adopt=_ADV_STATE, pop=tuple(
    k if k in ("fr_nodes", "fr_lbs", "opt_err", "converged", "final_lb")
    else _NO for k in _ADV_STATE))
_LANE_KEYS = ("nodes", "lbs", "opt_err", "thr", "best_node", "ub_terms",
              "min_dropped", "done", "cvals")     # o_nodes .. o_cvals
_LANE0 = _ADV_OUT.index("o_nodes")
_OUT_KEYS = dict(
    adopt=_ADV_STATE + (_NO,) * (len(_ADV_OUT) - len(_ADV_STATE)),
    pop=(_NO,) * 15 + ("converged", "final_lb", "pop_lb", "expand",
                       "child_nodes", "widths", "active", "R_lanes", "pts",
                       "mrd"),
    both=_ADV_STATE + (_NO, _NO, "child_nodes", "widths", "active",
                       "R_lanes", "pts_rot", "mrd"))
_OUT_LANE_KEYS = dict(pop=_LANE_KEYS + (_NO,) * 4,
                      both=_LANE_KEYS + _INNER_COUNTERS)


def _state_spec(cfg: GoICPConfig) -> dict:
    Cr = cfg.device_rot_capacity
    return dict(fr_nodes=((Cr, 4), _F32), fr_lbs=((Cr,), _F32),
                opt_err=((), _F32), opt_R=((3, 3), _F32),
                opt_t=((3,), _F32), comp=((), _I32), terms=((3,), _F32),
                last_icp=((), _B), min_dropped=((), _F32), it=((), _I32),
                evals=((), _I32), inner_it=((), _I32),
                icp_runs=((), _I32), geom_surv=((), _I32),
                chem_corners=((), _I32), converged=((), _B),
                final_lb=((), _F32))


def _lane_spec(cfg: GoICPConfig, L: int, reuse: bool) -> dict:
    C = cfg.trans_capacity
    spec = dict(nodes=((L, C, 4), _F32), lbs=((L, C), _F32),
                opt_err=((L,), _F32), thr=((L,), _F32),
                best_node=((L, 4), _F32), ub_terms=((L, 3), _F32),
                min_dropped=((L,), _F32), done=((L,), _B))
    if reuse:
        spec["cvals"] = ((L, C, 8 * len(_chem_terms(cfg))), _F32)
    return spec


def _pop_spec(cfg: GoICPConfig, L: int, nd: int) -> dict:
    Pr = cfg.rot_batch
    return dict(converged=((), _B), final_lb=((), _F32),
                pop_lb=((Pr,), _F32), expand=((Pr,), _B),
                child_nodes=((L, 4), _F32), widths=((L,), _F32),
                active=((L,), _B), R_lanes=((L, 3, 3), _F32),
                pts=((L, nd, 3), _F32), mrd=((L, nd), _F32))


def _alloc(spec: dict, n: int, dev, zero: bool = False) -> dict:
    """Empty (zero: zeroed) tensors of (n,) + shape for every entry of
    spec, one allocation per dtype, each a contiguous view starting on a
    16-byte boundary (where goicp_advance's bulk copies need it)."""
    out = {}
    for dt in {d for _, d in spec.values()}:
        names = [k for k, (_, d) in spec.items() if d == dt]
        sizes = [n * math.prod(spec[k][0]) for k in names]
        per = 16 // dt.itemsize
        spans = [-(-m // per) * per for m in sizes]
        buf = (torch.zeros if zero else torch.empty)(
            (sum(spans),), dtype=dt, device=dev)
        for k, m, part in zip(names, sizes, buf.split(spans)):
            out[k] = part[:m].view((n,) + spec[k][0])
    return {k: out[k] for k in spec}


def outputs(mode: str, cfg: GoICPConfig, n: int, nd: int, dev) -> dict:
    """Outputs of advance for n rows in `mode` ("pop": the pop's fields
    and its fresh `lanes`; "adopt": the device state without `it`;
    "both": the streams' window state), to pass as `out`.  The rows a
    call does not serve keep what they hold: zeros on the torch route
    (whose inner body evaluates every lane, done or not), the
    allocation's contents on the kernel's (whose inner step reads no
    done lane)."""
    L = cfg.rot_batch * 8
    reuse = _chem_reuse_active(cfg)
    zero = route(cfg, torch.empty(0, device=dev)) == "plain"
    if mode == "pop":
        out = _alloc(_pop_spec(cfg, L, nd), n, dev, zero)
        out["lanes"] = _alloc(_lane_spec(cfg, L, reuse), n, dev, zero)
        return out
    spec = _state_spec(cfg)
    if mode == "adopt":
        return _alloc({k: v for k, v in spec.items() if k != "it"}, n, dev,
                      zero)
    pop = _pop_spec(cfg, L, nd)
    spec.update(child_nodes=pop["child_nodes"], widths=pop["widths"],
                active=pop["active"], R_lanes=pop["R_lanes"],
                pts_rot=pop["pts"], mrd=pop["mrd"])
    out = _alloc(spec, n, dev, zero)
    lanes = _lane_spec(cfg, L, reuse)
    lanes.update({k: ((), _I32) for k in ("it", "evals", "geom_surv",
                                           "chem_corners")})
    out["inner"] = _alloc(lanes, n, dev, zero)
    return out


def _advance_specs(cfg: GoICPConfig, W: int, n: int, Wo: int, L: int,
                   nd: int, n_cells: int, S: int, reuse: bool) -> tuple:
    """(name, per-row shape, dtype, rows) of each of goicp_advance's
    slots: the state's, the pairs' (W rows), the served (n) and the
    outputs' (Wo)."""
    st = _state_spec(cfg)
    pop = _pop_spec(cfg, L, nd)
    lane = _lane_spec(cfg, L, reuse)
    hn = dict(lb_safe=((L,), _F32), cand_ub=((), _F32),
              incumbent=((), _F32), cand_R=((3, 3), _F32),
              cand_t=((3,), _F32), cand_terms=((3,), _F32),
              flags=((2,), _B), min_lb=((), _F32),
              **{k: (shp, dt) for k, shp, dt in _REFINE})
    spec = dict(st, active=((L,), _B), child_nodes=((L, 4), _F32),
                p_conv=((), _B), p_final=((), _F32),
                **{k: ((), _I32) for k in ("w_evals", "w_it", "w_surv",
                                           "w_corners")},
                data=((nd, 3), _F32), norm_data=((nd,), _F32),
                sse=((), _F32), cell_compat=((n_cells, 9), _F32),
                prop_onehot=((nd, 9), _F32), data_mask=((nd,), _F32),
                nearest_cell=((S ** 3,), _I32), consts=((5,), _F32))
    for k in _ADV_STATE:
        spec["o_" + k] = st[k]
    for k in ("pop_lb", "expand", "child_nodes", "widths", "active",
              "R_lanes", "pts", "mrd"):
        spec["o_" + k] = pop[k]
    for o, k in zip(_ADV_OUT[_LANE0:], _LANE_KEYS):
        spec[o] = lane.get(k, ((), _F32))
    for o in ("o_iit", "o_ievals", "o_isurv", "o_icorners"):
        spec[o] = ((), _I32)
    return tuple((k, *spec[k], W) for k in _ADV_ROWS) \
        + tuple((k, *hn[k], n) for k in _ADV_SERVED) \
        + tuple((k, *spec[k], W) for k in _ADV_PAIRS) \
        + tuple((k, *spec[k], Wo) for k in _ADV_OUT)



def _advance_ins(mode: str, pairs, s: dict, tables, h, r, p, work, min_lb,
                 reuse: bool) -> tuple:
    """The input slot tensors of goicp_advance (None where a slot is not
    used) and the inner search's work given as Python ints."""
    state = tuple(map(s.get, _STATE_READS[mode]))
    if not isinstance(state[_IT], torch.Tensor):
        state = state[:_IT] + (None,) + state[_IT + 1:]
    scal = [0, 0, 0, 0]
    if mode == "both":
        ctx = (s["active"], s["child_nodes"], None, None) + tuple(
            map(s["inner"].get, _INNER_COUNTERS))
    elif mode == "adopt":
        ws = []
        for j, k in enumerate(_WORK):
            v = work[k]
            if isinstance(v, torch.Tensor):
                ws.append(v.to(_I32).reshape(-1))
            else:
                ws.append(None)
                scal[j] = int(v)
        ctx = (p["active"], p["child_nodes"], p["converged"],
               p["final_lb"], *ws)
    else:
        ctx = (None,) * 8
    if mode == "pop":
        served = (None,) * 14
    else:
        served = tuple(map(h.get, _ADV_SERVED[:7])) + (
            (None,) * 7 if r is None else tuple(map(r.get, _REFINE_KEYS)))
    pin = (pairs.data, pairs.norm_data, tables.sse) + (
        (tables.cell_compat, tables.prop_onehot, tables.data_mask,
         tables.nearest_cell, tables.consts) if reuse and mode != "adopt"
        else (None,) * 5)
    return state + ctx + served + (min_lb,) + pin, scal


def advance(mode: str, cfg: GoICPConfig, pairs, s: dict, rows, *, tables,
            h=None, r=None, p=None, work=None, min_lb=None, out=None,
            out_rows=None, bufs: TransitionBuffers | None = None) -> dict:
    """The transition's pop, adoption or both for the rows `rows` of the
    W-row state `s` (see the module docstring), each row with its own pair
    (row w of the W-stacked PairData `pairs`; tables: their LaneTables,
    whose sse and chem tables the kernel reads).

      mode "pop": s needs fr_nodes, fr_lbs, opt_err, converged, final_lb;
        min_lb (n,): the lb the convergence is tested on (None: each
        row's first frontier lb).  Returns converged, final_lb (the
        pop's), pop_lb, expand (n, Pr), child_nodes, widths, active,
        R_lanes, pts (n, L, Nd, 3), mrd (n, L, Nd) and lanes: the inner
        search's fresh per-lane fields (inner.initial_lanes').
      mode "adopt": s a device state (with or without a tensor `it`); p
        the pop's outputs at the rows' indices of s (converged, final_lb,
        active, child_nodes); h the harvest's and r the refine block's
        rows (a run's search/args.py RefineRows, or dummy_refine_rows; None: no
        row refined); work the inner search's evals, iters, geom_surv,
        chem_corners, each (W,) int32 at the rows' indices or a Python
        int.  Returns the new state
        (without `it` where s has none).
      mode "both": s the streams' window state (fused layout, its pop
        context and inner counters inside), h and r as for adopt.
        Returns the rows' new window state.

    out / out_rows: write the results there (rows out_rows; None: the
    served rows' own indices) instead of into new outputs; where out is s
    itself a row may only be written over itself (out_rows None), each
    row served once.  bufs: the run's TransitionBuffers: new outputs come
    from its two sets for the mode in turn (valid until the call after
    next of that mode and shape), and the call's argument block is kept
    there, re-checked only where its tensors changed; None: new outputs
    and a block built for the call.  On the card (route) one launch of
    goicp_advance, else advance_plain."""
    rows = [int(w) for w in rows]
    n = len(rows)
    dev = s["opt_err"].device
    Pr = cfg.rot_batch
    L = Pr * 8
    W = s["opt_err"].shape[0]
    nd = pairs.data.shape[-2]
    kind = ("advance", mode, n, nd, W)

    def alloc():
        return outputs(mode, cfg, n, nd, dev)

    reuse = _chem_reuse_active(cfg)
    if route(cfg, s["opt_err"]) == "plain":
        if out is None and bufs is not None:
            ins, _ = _advance_ins(mode, pairs, s, tables, h, r, p, work,
                                  min_lb, reuse)
            out = bufs.take(kind, alloc, ins)[1]
            out_rows = list(range(n))
        return advance_plain(mode, cfg, pairs, s, rows, h=h, r=r, p=p,
                             work=work, min_lb=min_lb, out=out,
                             out_rows=out_rows)
    n_cells, S = tables.cell_compat.shape[-2], tables.size
    ins, scal = _advance_ins(mode, pairs, s, tables, h, r, p, work, min_lb,
                             reuse)
    ints = (_MODES[mode], n, L, cfg.device_rot_capacity, Pr,
            cfg.trans_capacity, nd, n_cells, S, int(cfg.icp_on_improve),
            *scal)
    cuda_eval._check_envelope("transition", nd, n_cells, S)
    given = out is not None
    if given and out_rows is None:
        out_rows = rows
    Wo = out["opt_err" if mode != "pop" else "final_lb"].shape[0] if given \
        else n

    def make(t):
        return TransitionArgs(
            _advance_specs(cfg, W, n, Wo, L, nd, n_cells, S, reuse), t,
            len(ins), dev, ints, (cfg.transMinX, cfg.transMinY, cfg.transMinZ,
                                  cfg.transWidth), n=n, out_rows=given)

    out, blk = _call_block(bufs, kind, alloc, ins,
                           lambda o: _out_tensors(mode, o), make, out,
                           (ints, Wo))
    blk.rows[:] = rows
    if given:
        blk.out_rows[:] = [int(o) for o in out_rows]
    _launch(kernels.goicp_advance(
        blk.ptrs, len(blk.ptrs), blk.ints, len(blk.ints), blk.root,
        blk.rows, blk.out_rows, n, _stream(s["opt_err"])),
        f"advance ({mode})")
    advance.launches += 1
    return out


advance.launches = 0


def _out_tensors(mode: str, out: dict) -> tuple:
    """goicp_advance's output slot tensors from out's fields (None where
    the mode writes no such field)."""
    if mode == "adopt":
        return tuple(map(out.get, _OUT_KEYS["adopt"]))
    lanes = out["lanes" if mode == "pop" else "inner"]
    return tuple(map(out.get, _OUT_KEYS[mode])) \
        + tuple(map(lanes.get, _OUT_LANE_KEYS[mode]))
