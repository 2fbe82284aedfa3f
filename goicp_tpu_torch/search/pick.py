"""The end of an ICP event on the card: the seeds it starts from, the
pick of the best seed, the BnB candidate's count and the refine record;
and the initial incumbent.

Port of what goicp_tpu/search/device_engine.py's _icp_best_of_seeds
(:199-231) and _initial_incumbent (:140-181) do around their ICP event,
with the candidate's compatibility count that every engine computes
beside the pick (device_engine._make_body's refine block).

The engines' refinement, refine_rows, is on the card one launch for
every row of a transition that refines (icp_refine: csrc/icp.cu's refine
route, goicp_icp_refine): each row's K ICP events from its K lowest-ub
lanes, the K results rescored, the first best picked and written with the
candidate's count into the row's record row, the other rows set to the
dummy; no host read.  It computes what three launches a row computed
before, and still compute for the tests and the measurements (each also
one launch of csrc/score.cu, whose bodies the refine route shares through
csrc/score_body.cuh):

  icp_seeds      (goicp_icp_seeds) the K lowest-ub lanes, ties to the
                 lower lane (torch.argsort(stable=True)'s first K, JAX's
                 lax.top_k(-ubs, K)), their R and t = c + w / 2; given a
                 refine record, its rows set to the dummy of a row that
                 did not refine, in the same launch;
  icp_run        the ICP event (icp/icp.py);
  score_pick     (goicp_score_pick, route kPick) the K ICP results'
                 rescoring (bounds/error.py's score_transform and
                 icp_chem_terms' count), the first best seed
                 (torch.argmin), the candidate's BnB count, all written
                 into row j of the refine record.

The initial incumbent (initial_incumbent) is, on the card, one launch of
csrc/icp.cu's initial route (icp_init, goicp_icp_init): K clusters run
the ICP event from the K starts of init_seeds and rescore their results,
one more block computes the initial error beside them, and the last
arrival forms the incumbent _initial_incumbent forms (pick_write's route
kInit), written into the state's tensors; no host read.  score_initial
(goicp_score_pick's route kInit after icp_run's launch, the two launches
the initial route replaced) stays as the shared body's check.  The
*_plain twins are the torch bodies the engines ran before (argsort and
gathers; rescore, argmin and the picks by index), the CPU's route and the
kernels' yardstick: the same bits.  There is no other fallback: a failed
build or launch raises, and a tensor outside the kernels' envelope raises
ValueError.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from goicp_tpu_torch.bounds.error import (_SLOT_TYPES, _SLOTS, Score, _rows,
                                          _score_args, _score_ints,
                                          _slot_tensors,
                                          bnb_incompatibility_count_plain,
                                          icp_chem_terms, initial_error_plain,
                                          score_transform_plain)
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.geom.rotation import rodrigues
from goicp_tpu_torch.icp.icp import (ICP_SMEM_BYTES, icp_mode, icp_run,
                                    icp_run_plain)
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.search.args import REFINE_ROWS, RefineRecord, RefineRows
from goicp_tpu_torch.search.transition import reset_refine, set_refine
from goicp_tpu_torch.utils.fp32 import (_launch, _on_card, _ptr, _stream,
                                        kernels)

PICK, INIT = 0, 1      # goicp_score_pick's routes (csrc/score.cu)
CLUSTER = 8            # seeds a pick serves in one cluster; above: tickets

# fixed coarse SO(3) multi-start seeds for the initial ICP (axis-angle;
# entry 0 = identity, the reference's only seed)
INIT_SEED_RV = np.array(
    [[0.0, 0.0, 0.0],
     [np.pi / 2, 0.0, 0.0], [0.0, np.pi / 2, 0.0], [0.0, 0.0, np.pi / 2],
     [np.pi, 0.0, 0.0], [0.0, np.pi, 0.0], [0.0, 0.0, np.pi],
     [1.2091996, 1.2091996, 1.2091996]],    # 120-deg about (1,1,1)
    np.float32)

_F32, _I32 = torch.float32, torch.int32


def icp_kw(pair: PairData, cfg: GoICPConfig) -> dict:
    """icp_run's keywords for an engine's ICP event on `pair`."""
    return dict(inlier_num=pair.inlier_num, max_iter=cfg.icp_max_iter,
                err_diff=cfg.err_diff,
                data_mask=pair.data_mask if pair.padded else None,
                count=pair.inlier_f() if pair.dynamic_counts else None,
                dynamic_trim=pair.dynamic_counts and cfg.doTrim)


def _pick(sc: Score, i) -> Score:
    return Score(*(x[i] for x in sc))


# ---------------------------------------------------------------------------
# the seeds
# ---------------------------------------------------------------------------

def icp_seeds_plain(ubs: torch.Tensor, R_lanes: torch.Tensor,
                    best_nodes: torch.Tensor, K: int, out=None,
                    reset: dict | None = None) -> tuple:
    """icp_seeds in torch ops (device_engine._icp_best_of_seeds' head)."""
    seed_lanes = torch.argsort(ubs, stable=True)[:K]
    seed_R = R_lanes[seed_lanes]                        # (K,3,3)
    seed_tn = best_nodes[seed_lanes]
    seed_t = seed_tn[:, :3] + seed_tn[:, 3:4] / 2.0     # (K,3)
    if reset is not None:
        reset_refine(reset)
    if out is None:
        return seed_R, seed_t
    out[0].copy_(seed_R)
    out[1].copy_(seed_t)
    return out


def icp_seeds(ubs: torch.Tensor, R_lanes: torch.Tensor,
              best_nodes: torch.Tensor, K: int, out=None,
              reset: RefineRows | None = None) -> tuple:
    """(seed_R (K, 3, 3), seed_t (K, 3)): the K lowest-ub lanes of ubs
    (L,), ties to the lower lane, their R_lanes (L, 3, 3) rows and the
    centres c + w / 2 of their best_nodes (L, 4).  out: the (R, t) to
    write (None: new tensors).  reset: a refine record whose rows the call
    sets to the dummy.  On the card one launch of goicp_icp_seeds
    (icp_seeds.launches), else icp_seeds_plain."""
    if not _on_card(ubs, R_lanes, best_nodes):
        return icp_seeds_plain(ubs, R_lanes, best_nodes, K, out, reset)
    L = ubs.shape[0]
    if not 0 < K <= L:
        raise ValueError(f"icp_seeds takes 0 < K <= L, got K={K}, L={L}")
    ubs = _rows(ubs, (L,), "ubs")
    R_lanes = _rows(R_lanes, (L, 3, 3), "R_lanes")
    best_nodes = _rows(best_nodes, (L, 4), "best_nodes")
    if out is None:
        out = (torch.empty((K, 3, 3), dtype=_F32, device=ubs.device),
               torch.empty((K, 3), dtype=_F32, device=ubs.device))
    elif out[0].shape != (K, 3, 3) or out[1].shape != (K, 3) \
            or not (out[0].is_contiguous() and out[1].is_contiguous()):
        raise ValueError(f"icp_seeds writes contiguous (K, 3, 3), (K, 3) "
                         f"seeds, got {tuple(out[0].shape)}, "
                         f"{tuple(out[1].shape)}")
    _launch(kernels.goicp_icp_seeds(
        ubs.data_ptr(), R_lanes.data_ptr(), best_nodes.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), L, K,
        None if reset is None else reset.ptrs,
        0 if reset is None else reset.n, _stream(ubs)), "icp_seeds")
    icp_seeds.launches += 1
    return out


icp_seeds.launches = 0


# ---------------------------------------------------------------------------
# the pick and the initial incumbent
# ---------------------------------------------------------------------------

def _rescore_plain(pair, cfg, R, t, nn_idx):
    return (score_transform_plain(pair, cfg, R, t, nn_idx),
            icp_chem_terms(pair, cfg, nn_idx)[3])


def score_pick_plain(pair: PairData, cfg: GoICPConfig, R: torch.Tensor,
                     t: torch.Tensor, nn_idx: torch.Tensor,
                     cand_R: torch.Tensor, cand_t: torch.Tensor, rec: dict,
                     j: int) -> None:
    """score_pick in torch ops (device_engine._icp_best_of_seeds' tail and
    the refine block the engines wrote with set_refine)."""
    scs, incs = _rescore_plain(pair, cfg, R, t, nn_idx)
    bi = torch.argmin(scs.error)
    sc = _pick(scs, bi)
    set_refine(rec, j, dict(
        icp_R=R[bi], icp_t=t[bi], icp_err=sc.error,
        icp_terms=torch.stack([sc.geom, sc.incomp_term + sc.nbr_term,
                               sc.fpfh_term]),
        icp_incomp=incs[bi].to(_I32),
        bnb_comp=bnb_incompatibility_count_plain(pair, cfg, cand_R,
                                                 cand_t).to(_I32)))


def score_initial_plain(pair: PairData, cfg: GoICPConfig, R: torch.Tensor,
                        t: torch.Tensor, nn_idx: torch.Tensor) -> dict:
    """score_initial in torch ops (device_engine._initial_incumbent's
    tail)."""
    dev = pair.device
    init_err = initial_error_plain(pair, cfg)
    scs, incs = _rescore_plain(pair, cfg, R, t, nn_idx)
    bi = 0 if R.shape[0] == 1 else torch.argmin(scs.error)
    sc0 = _pick(scs, bi)
    icp0_incomp = incs[bi].to(_I32)
    better0 = sc0.error < init_err
    eye = torch.eye(3, device=dev)
    zero3 = torch.zeros(3, device=dev)
    return dict(
        opt_err=torch.where(better0, sc0.error, init_err),
        opt_R=torch.where(better0, R[bi], eye),
        opt_t=torch.where(better0, t[bi], zero3),
        comp=torch.where(better0, icp0_incomp,
                         torch.zeros_like(icp0_incomp)),
        terms=torch.where(better0,
                          torch.stack([sc0.geom, sc0.incomp_term
                                       + sc0.nbr_term, sc0.fpfh_term]),
                          torch.stack([init_err, zero3[0], zero3[0]])),
        last_icp=better0)


# PickOut's fields, in its order (None: bnb, which the initial route
# does not write)
_PICK_OUT = ("opt_R", "opt_t", "opt_err", "terms", "comp", None, "last_icp")


def incumbent_tensors(dev) -> tuple:
    """(an initial incumbent's tensors on dev in the state's order, the
    PickOut pointers the kernels write them by): views of one 18-word
    allocation, each field in words of its own."""
    buf = torch.empty((18,), dtype=_F32, device=dev)
    out = dict(opt_err=buf[12], opt_R=buf[:9].view(3, 3), opt_t=buf[9:12],
               comp=buf[16].view(_I32), terms=buf[13:16],
               last_icp=buf[17:].view(torch.uint8)[0].view(torch.bool))
    ptrs = (ctypes.c_ulonglong * len(_PICK_OUT))(
        *(0 if k is None else out[k].data_ptr() for k in _PICK_OUT))
    return out, ptrs


_tickets: dict = {}     # device -> (rows (K + 1) * 7 float32, ticket int32)


def _ticket_ws(dev: torch.device, K: int) -> tuple:
    """The ticket form's workspace on dev for K seeds (made once, grown
    where K is larger; the kernel leaves the ticket 0)."""
    ws = _tickets.get(str(dev))
    if ws is None or ws[0].numel() < (K + 1) * 7:
        ws = (torch.empty(((K + 1) * 7,), dtype=_F32, device=dev),
              torch.zeros((1,), dtype=_I32, device=dev))
        _tickets[str(dev)] = ws
    return ws


def _pick_launch(pair, cfg, R, t, nn_idx, cand_R, cand_t, out_ptrs, j,
                 route, who):
    args = _score_args(pair, cfg)
    K = R.shape[0]
    nd = pair.n_data_padded
    if K == 0:
        raise ValueError(f"{who} takes at least one ICP result")
    R, t = _rows(R, (K, 3, 3), "R"), _rows(t, (K, 3), "t")
    if nn_idx.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"nn_idx must be int64 or int32, got {nn_idx.dtype}")
    nn_idx = _rows(nn_idx, (K, nd), "nn_idx")
    if cand_R is not None:
        cand_R = _rows(cand_R, (3, 3), "cand_R")
        cand_t = _rows(cand_t, (3,), "cand_t")
    ws, ticket = _ticket_ws(R.device, K) if K > CLUSTER else (None, None)
    _launch(kernels.goicp_score_pick(
        args.slots, args.ints, args.floats, R.data_ptr(), t.data_ptr(),
        nn_idx.data_ptr(), int(nn_idx.dtype is torch.int64), K,
        None if cand_R is None else cand_R.data_ptr(),
        None if cand_t is None else cand_t.data_ptr(), out_ptrs, j, route,
        None if ws is None else ws.data_ptr(),
        None if ticket is None else ticket.data_ptr(), _stream(R)), who)


def score_pick(pair: PairData, cfg: GoICPConfig, R: torch.Tensor,
               t: torch.Tensor, nn_idx: torch.Tensor, cand_R: torch.Tensor,
               cand_t: torch.Tensor, rec: RefineRows, j: int) -> None:
    """Row j of the refine record `rec` <- the best of an ICP event's K
    results R (K, 3, 3), t (K, 3), nn_idx (K, Nd) (the first least
    rescored error, torch.argmin's rule), with the BnB candidate's count
    at cand_R (3, 3), cand_t (3,), do_icp set.  On the card one launch of
    goicp_score_pick (score_pick.launches: one cluster of K + 1 <= 8
    blocks, or K blocks and a ticket above 8 seeds), else
    score_pick_plain."""
    if not _on_card(pair.data, R, t, cand_R, cand_t):
        return score_pick_plain(pair, cfg, R, t, nn_idx, cand_R, cand_t,
                                rec, j)
    if rec.ptrs is None or not 0 <= j < rec.n:
        raise ValueError(f"score_pick writes row j < {rec.n} of a refine "
                         f"record on the card, got j={j}")
    _pick_launch(pair, cfg, R, t, nn_idx, cand_R, cand_t, rec.ptrs, j, PICK,
                 "score_pick")
    score_pick.launches += 1


score_pick.launches = 0


def score_initial(pair: PairData, cfg: GoICPConfig, R: torch.Tensor,
                  t: torch.Tensor, nn_idx: torch.Tensor) -> dict:
    """The initial incumbent of device_engine._initial_incumbent from its
    ICP event's K results: new tensors opt_err, opt_R, opt_t, comp,
    terms, last_icp (the initial error's where no seed beats it).  On the
    card one launch of goicp_score_pick (route kInit,
    score_initial.launches), else score_initial_plain.  The engines'
    initial incumbents take the initial route (icp_init), which computes
    this in the ICP event's launch; this stays as the shared body's
    check and the second yardstick's tail."""
    if not _on_card(pair.data, R, t):
        return score_initial_plain(pair, cfg, R, t, nn_idx)
    out, ptrs = incumbent_tensors(pair.device)
    _pick_launch(pair, cfg, R, t, nn_idx, None, None, ptrs, 0, INIT,
                 "score_initial")
    score_initial.launches += 1
    return out


score_initial.launches = 0


# ---------------------------------------------------------------------------
# the refine route: every refining row of a transition in one launch
# ---------------------------------------------------------------------------

# a refine row's slots (csrc/icp.cu's RefineRow): the pair's rescoring
# slots, then the ICP's model and the row's lanes and candidate
_REFINE_NAMES = _SLOTS + ("model", "R_lanes", "best_nodes", "ubs", "cand_R",
                          "cand_t")
_REFINE_TYPES = _SLOT_TYPES + (torch.float32,) * 6


def _refine_tensors(pair: PairData, R_lanes, best_nodes, ubs, cand_R,
                    cand_t) -> tuple:
    return _slot_tensors(pair) + (pair.model, R_lanes, best_nodes, ubs,
                                  cand_R, cand_t)


def _refine_shapes(pair: PairData, L: int) -> tuple:
    """What a row's slots must be shaped as: the bucket's padded shapes of
    `pair` (the first row's), the lanes' at L."""
    ts = _slot_tensors(pair)
    nd, M = pair.n_data_padded, pair.model.shape[0]
    want = dict(data=(nd, 3), weights=(nd,), data_mask=(nd,),
                data_props=(nd,), model_props=(M,), data_nbrs=(nd,),
                model_nbrs=(M,), counts=(3,))
    shapes = tuple(torch.Size(want.get(name, x.shape))
                   for name, x in zip(_SLOTS, ts))
    if pair.compat_table.shape[0] != nd or pair.data_fpfh.shape[0] != nd \
            or pair.model_fpfh.shape[0] != M:
        raise ValueError(f"inconsistent pair shapes: data "
                         f"{tuple(pair.data.shape)}, compat_table "
                         f"{tuple(pair.compat_table.shape)}, data_fpfh "
                         f"{tuple(pair.data_fpfh.shape)}, model_fpfh "
                         f"{tuple(pair.model_fpfh.shape)}")
    return shapes + tuple(torch.Size(x) for x in (
        (M, 3), (L, 3, 3), (L, 4), (L,), (3, 3), (3,)))


def _refine_ints(cfg: GoICPConfig, pair: PairData, K: int, L: int) -> tuple:
    """(ints, floats) of goicp_icp_refine: ScoreArgs', then K, L, M,
    max_iter, the ICP's mask mode, whether it reads data_mask and counts
    (icp_kw's data_mask and count); err_diff."""
    ints, floats = _score_ints(pair, cfg)
    padded, dynamic = pair.padded, pair.dynamic_counts
    mode = icp_mode(pair.n_data_padded, pair.inlier_num,
                    True if dynamic else None, True if padded else None,
                    dynamic and bool(cfg.doTrim))
    return (ints + (K, L, pair.model.shape[0], int(cfg.icp_max_iter), mode,
                    int(padded), int(dynamic)),
            floats + (float(cfg.err_diff),))


def icp_refine(cfg: GoICPConfig, todo: list, rec: RefineRows,
               record: RefineRecord, enabled=None) -> None:
    """The refine route on the card: every row of `todo` (refine_rows')
    refined into `rec` and the record's other rows set to the dummy, in
    one launch of goicp_icp_refine (one a REFINE_ROWS rows;
    icp_refine.launches) and no host read.  The rows' tensors may each be
    their own (a window's rows, a batch chunk's, a lone pair) but must
    share the first row's padded shapes and host counts (else
    ValueError); K = min(icp_seeds, L) is the same for every row.  The
    argument block is the record's (RefineArgs): a row's slots are checked
    again only where they hold other tensors than at the call before."""
    if rec.ptrs is None:
        raise ValueError("icp_refine writes a refine record on the card")
    todo = sorted(todo, key=lambda x: x[0])
    js = [x[0] for x in todo]
    if len(set(js)) != len(js) or js[0] < 0 or js[-1] >= rec.n:
        raise ValueError(f"icp_refine refines distinct rows j < {rec.n}, "
                         f"got {js}")
    pair0, L = todo[0][1], todo[0][2].shape[0]
    K = min(cfg.icp_seeds, L)
    dev = rec["icp_err"].device
    shapes = _refine_shapes(pair0, L)
    host = (pair0.n_data_padded, pair0.inlier_num, pair0.n_data,
            pair0.dynamic_counts)
    key = (cfg.norm, bool(cfg.doTrim), cfg.regularization,
           cfg.regularizationNeighbors, cfg.regularizationFPFH, cfg.cfpfh,
           cfg.icp_max_iter, cfg.err_diff, K, shapes, host, str(dev))
    blk = record.args
    if key != blk.key:
        blk.held = [(None,) * len(_REFINE_NAMES)] * len(blk.held)
    blk.set_ints(key, lambda: _refine_ints(cfg, pair0, K, L))
    rows = []
    for j, pair, *lane in todo:
        got = (pair.n_data_padded, pair.inlier_num, pair.n_data,
               pair.dynamic_counts)
        if got != host:
            raise ValueError(f"icp_refine's rows share the bucket's counts "
                             f"{host}; row {j} has {got}")
        rows.append((j, _refine_tensors(pair, *lane)))

    def check(k, x):
        if not x.is_contiguous():
            x = x.contiguous()
        if x.device != dev or x.dtype != _REFINE_TYPES[k] \
                or x.shape != shapes[k]:
            raise ValueError(
                f"icp_refine takes {_REFINE_NAMES[k]} as a {_REFINE_TYPES[k]}"
                f" tensor of shape {tuple(shapes[k])} on {dev} (the rows "
                f"share the bucket's padded shapes); got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
        return x
    blk.bind(rows, check)
    en = None
    if enabled is not None:
        en = torch.as_tensor(enabled, device=dev)
        if en.numel() != 1:
            raise ValueError(f"icp_refine takes one enabled flag for every "
                             f"row, got shape {tuple(en.shape)}")
        en = en.to(torch.bool).reshape(())
    rows_ws, tickets = record.launch_buffers(K, dev)
    nd, M = pair0.n_data_padded, pair0.model.shape[0]
    words = 10 * nd + 4 * M       # a row's ICP workspace; then its lanes
    ws = None if 4 * (words + 14 * L) <= ICP_SMEM_BYTES else \
        record.workspace(REFINE_ROWS * K * words, dev)
    n = len(rows)
    _launch(kernels.goicp_icp_refine(
        blk.slots, blk.j, n, blk.ints, blk.floats, rec.ptrs, rec.n,
        rows_ws.data_ptr(), tickets.data_ptr(), _ptr(en), _ptr(ws),
        _stream(rows_ws)), "icp_refine")
    icp_refine.launches += -(-n // REFINE_ROWS)


icp_refine.launches = 0


# ---------------------------------------------------------------------------
# the engines' calls
# ---------------------------------------------------------------------------

def refine_rows(cfg: GoICPConfig, todo: list, n: int, dev,
                record: RefineRecord | None = None,
                enabled: torch.Tensor | None = None) -> RefineRows | None:
    """The refine block of a transition's n rows with the rows of `todo`
    refined, None where todo is empty.  todo: (j, pair, R_lanes (L, 3, 3),
    best_nodes (L, 4), ubs (L,), cand_R (3, 3), cand_t (3,)) for each row
    j that refines: ICP from its K = min(icp_seeds, L) lowest-ub lanes,
    the best seed and the candidate's count written into row j.  The
    other rows hold the dummy.  record: the run's RefineRecord, whose
    block for n rows is written (valid until the next call); None: a new
    one.  enabled (0-d bool): where False the ICP runs no iteration (the
    sharded engine's).  On the card one launch for every row (icp_refine)
    and no host read; on the CPU the plain composition, row by row:
    icp_seeds_plain, icp_run_plain, score_pick_plain."""
    if not todo:
        return None
    if not _on_card(*todo[0][2:]):
        return refine_rows_plain(cfg, todo, n, dev, record, enabled)
    record = RefineRecord() if record is None else record
    rec = record.rows(n, dev)
    icp_refine(cfg, todo, rec, record, enabled)
    return rec


def _by_row(cfg, todo, n, dev, record, enabled, seeds, run, pick_):
    record = RefineRecord() if record is None else record
    rec = record.rows(n, dev)
    for i, (j, pair, R_lanes, best_nodes, ubs, cand_R, cand_t) in \
            enumerate(todo):
        K = min(cfg.icp_seeds, R_lanes.shape[0])
        seed_R, seed_t = seeds(
            ubs, R_lanes, best_nodes, K, out=record.seeds(K, dev),
            reset=rec if i == 0 and len(todo) < n else None)
        r = run(pair.data, pair.model, seed_R, seed_t, **icp_kw(pair, cfg),
                enabled=enabled)
        pick_(pair, cfg, r.R, r.t, r.nn_idx, cand_R, cand_t, rec, j)
    return rec


def refine_rows_plain(cfg: GoICPConfig, todo: list, n: int, dev,
                      record: RefineRecord | None = None,
                      enabled: torch.Tensor | None = None
                      ) -> RefineRows | None:
    """refine_rows in torch ops, row by row (icp_seeds_plain, the first
    row's resetting the record where not every row refines; icp_run_plain;
    score_pick_plain): the CPU's route and the refine route's yardstick."""
    if not todo:
        return None
    return _by_row(cfg, todo, n, dev, record, enabled, icp_seeds_plain,
                   icp_run_plain, score_pick_plain)


def refine_rows_by_launches(cfg: GoICPConfig, todo: list, n: int, dev,
                            record: RefineRecord | None = None,
                            enabled: torch.Tensor | None = None
                            ) -> RefineRows | None:
    """refine_rows as the composition that the refine route took into one
    launch: on the card three launches a row (icp_seeds, icp_run,
    score_pick), each on the plain route on the CPU.  Kept as the refine
    route's second yardstick and for the measurements."""
    if not todo:
        return None
    return _by_row(cfg, todo, n, dev, record, enabled, icp_seeds, icp_run,
                   score_pick)


_init_seeds: dict = {}     # (device, K) -> (R (K, 3, 3), t (K, 3))


def init_seeds(K: int, dev) -> tuple:
    """The initial ICP's K starts: rodrigues of INIT_SEED_RV[:K] and zero
    translations, made once per device and K for the process (the same
    rodrigues, so the same bits as a call a registration)."""
    key = (str(dev), K)
    if key not in _init_seeds:
        _init_seeds[key] = (
            rodrigues(torch.as_tensor(INIT_SEED_RV[:K], device=dev)),
            torch.zeros((K, 3), dtype=_F32, device=dev))
    return _init_seeds[key]


def initial_incumbent_plain(pair: PairData, cfg: GoICPConfig) -> dict:
    """initial_incumbent as the plain composition (icp_run_plain from
    init_seeds' starts, then score_initial_plain): the CPU's route and the
    initial route's yardstick."""
    K = _init_K(cfg)
    R0, t0 = init_seeds(K, pair.device)
    r = icp_run_plain(pair.data, pair.model, R0, t0, **icp_kw(pair, cfg))
    return score_initial_plain(pair, cfg, r.R, r.t, r.nn_idx)


def initial_incumbent_by_launches(pair: PairData, cfg: GoICPConfig) -> dict:
    """initial_incumbent as the two launches the initial route replaced
    (icp_run, then score_initial: goicp_score_pick's route kInit); each
    the plain route on the CPU.  Kept as the initial route's second
    yardstick and for the measurements."""
    K = _init_K(cfg)
    R0, t0 = init_seeds(K, pair.device)
    r = icp_run(pair.data, pair.model, R0, t0, **icp_kw(pair, cfg))
    return score_initial(pair, cfg, r.R, r.t, r.nn_idx)


def _init_K(cfg: GoICPConfig) -> int:
    return max(1, min(int(cfg.init_seeds), len(INIT_SEED_RV)))


def _init_args(pair: PairData, cfg: GoICPConfig, K: int) -> tuple:
    """The initial route's slot block for a pair and configuration: the
    rescoring's (bounds/error.py::_score_args, kept on the pair) and the
    ints and floats of goicp_icp_init, kept on the pair per configuration
    and K while the pair holds the same tensors."""
    args = _score_args(pair, cfg)
    key = (cfg.norm, bool(cfg.doTrim), cfg.regularization,
           cfg.regularizationNeighbors, cfg.regularizationFPFH, cfg.cfpfh,
           cfg.icp_max_iter, cfg.err_diff, K)
    cache = pair.__dict__.setdefault("_init_args", {})
    got = cache.get(key)
    if got is None or got[0] is not args or got[1] is not pair.model:
        model = pair.model
        M = pair.model.shape[0]
        if model.dtype != _F32 or model.shape != (M, 3) \
                or not model.is_contiguous() or model.device != pair.device:
            raise ValueError(f"the initial route takes the model as a "
                             f"contiguous float32 (M, 3) tensor on "
                             f"{pair.device}, got {model.dtype} "
                             f"{tuple(model.shape)} on {model.device}")
        ints, floats = _refine_ints(cfg, pair, K, K)
        got = (args, model, (ctypes.c_int * len(ints))(*ints),
               (ctypes.c_float * len(floats))(*floats))
        cache[key] = got
    return got


def icp_init(pair: PairData, cfg: GoICPConfig) -> dict:
    """The initial route on the card: the pair's initial incumbent in new
    tensors (incumbent_tensors), which it returns, in one launch of
    goicp_icp_init (icp_init.launches) and no host read.  The launch's
    buffers (its row's words and ticket, the ICP's device workspace where
    the cloud does not fit a block's shared memory) are the pair's own, a
    RefineRecord kept on it."""
    K = _init_K(cfg)
    dev = pair.device
    R0, t0 = init_seeds(K, dev)
    args, model, ints, floats = _init_args(pair, cfg, K)
    out, ptrs = incumbent_tensors(dev)
    nd, M = pair.n_data_padded, model.shape[0]
    words = 10 * nd + 4 * M       # a row's one-block ICP workspace
    record = pair.__dict__.get("_init_record")
    if record is None:
        record = pair.__dict__["_init_record"] = RefineRecord()
    rows_ws, tickets = record.launch_buffers(K, dev)
    ws = None if 4 * words <= ICP_SMEM_BYTES else \
        record.workspace((K + 1) * words, dev)
    _launch(kernels.goicp_icp_init(
        args.slots, ints, floats, model.data_ptr(), R0.data_ptr(),
        t0.data_ptr(), ptrs, rows_ws.data_ptr(), tickets.data_ptr(),
        _ptr(ws), _stream(rows_ws)), "icp_init")
    icp_init.launches += 1
    return out


icp_init.launches = 0


def initial_incumbent(pair: PairData, cfg: GoICPConfig) -> dict:
    """The initial incumbent (device_engine._initial_incumbent): ICP from
    the identity and, with cfg.init_seeds > 1, from K - 1 coarse
    rotations too, the best seed adopted where it beats the initial
    error: opt_err, opt_R, opt_t, comp, terms, last_icp, the tensors a
    state holds.  On the card one launch of the initial route (icp_init)
    and no host read; on the CPU initial_incumbent_plain."""
    if not _on_card(pair.data):
        return initial_incumbent_plain(pair, cfg)
    return icp_init(pair, cfg)
