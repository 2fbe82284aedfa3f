"""The end of an ICP event on the card: the seeds it starts from, the
pick of the best seed, the BnB candidate's count and the refine record;
and the initial incumbent.

Port of what goicp_tpu/search/device_engine.py's _icp_best_of_seeds
(:199-231) and _initial_incumbent (:140-181) do around their ICP event,
with the candidate's compatibility count that every engine computes
beside the pick (device_engine._make_body's refine block).  On the card
each of the three steps around icp_run is one launch of csrc/score.cu:

  icp_seeds      (goicp_icp_seeds) the K lowest-ub lanes, ties to the
                 lower lane (torch.argsort(stable=True)'s first K, JAX's
                 lax.top_k(-ubs, K)), their R and t = c + w / 2; given a
                 refine record, its rows set to the dummy of a row that
                 did not refine, in the same launch;
  score_pick     (goicp_score_pick, route kPick) the K ICP results'
                 rescoring (bounds/error.py's score_transform and
                 icp_chem_terms' count), the first best seed
                 (torch.argmin), the candidate's BnB count, all written
                 into row j of the refine record;
  score_initial  (route kInit) the same rescoring, the initial error and
                 the incumbent _initial_incumbent forms from them,
                 written into new state tensors.

refine_rows and initial_incumbent put them around icp_run: a refinement
is three launches and an initial incumbent two, and neither reads the
host (the engine before picked with a 0-d index, one host read a field).
The *_plain twins are the torch bodies the engines ran before (argsort
and gathers; rescore, argmin and the picks by index), the CPU's route and
the kernels' yardstick: the same bits.  There is no other fallback: a
failed build or launch raises, and a tensor outside the kernels'
envelope raises ValueError.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from goicp_tpu_torch.bounds.error import (Score, _rows, _score_args,
                                          bnb_incompatibility_count_plain,
                                          icp_chem_terms, initial_error_plain,
                                          score_transform_plain)
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.geom.rotation import rodrigues
from goicp_tpu_torch.icp.icp import icp_run
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.search.args import RefineRecord, RefineRows
from goicp_tpu_torch.search.transition import reset_refine, set_refine
from goicp_tpu_torch.utils.fp32 import _launch, _on_card, _stream, kernels

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


_INITIAL = (("opt_R", (3, 3), _F32), ("opt_t", (3,), _F32),
            ("opt_err", (), _F32), ("terms", (3,), _F32),
            ("comp", (), _I32), (None, None, None),
            ("last_icp", (), torch.bool))      # in PickOut's order
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
    score_initial.launches), else score_initial_plain."""
    if not _on_card(pair.data, R, t):
        return score_initial_plain(pair, cfg, R, t, nn_idx)
    dev = pair.device
    out = {k: torch.empty(shape, dtype=dt, device=dev)
           for k, shape, dt in _INITIAL if k is not None}
    ptrs = (ctypes.c_ulonglong * len(_INITIAL))(
        *(0 if k is None else out[k].data_ptr() for k, _, _ in _INITIAL))
    _pick_launch(pair, cfg, R, t, nn_idx, None, None, ptrs, 0, INIT,
                 "score_initial")
    score_initial.launches += 1
    return {k: out[k] for k in ("opt_err", "opt_R", "opt_t", "comp",
                                "terms", "last_icp")}


score_initial.launches = 0


# ---------------------------------------------------------------------------
# the engines' calls
# ---------------------------------------------------------------------------

def refine_rows(cfg: GoICPConfig, todo: list, n: int, dev,
                record: RefineRecord | None = None,
                enabled: torch.Tensor | None = None) -> RefineRows | None:
    """The refine block of a transition's n rows with the rows of `todo`
    refined, None where todo is empty.  todo: (j, pair, R_lanes (L, 3, 3),
    best_nodes (L, 4), ubs (L,), cand_R (3, 3), cand_t (3,)) for each row
    j that refines: ICP from its K = min(icp_seeds, L) lowest-ub lanes
    (icp_seeds, icp_run), the best seed and the candidate's count written
    into row j (score_pick).  The other rows hold the dummy (set in the
    first row's seeds launch).  record: the run's RefineRecord, whose
    block for n rows is written (valid until the next call); None: a new
    one.  enabled (0-d bool): where False the ICP runs no iteration (the
    sharded engine's).  On the card three launches a refining row and no
    host read."""
    if not todo:
        return None
    record = RefineRecord() if record is None else record
    rec = record.rows(n, dev)
    for i, (j, pair, R_lanes, best_nodes, ubs, cand_R, cand_t) in \
            enumerate(todo):
        K = min(cfg.icp_seeds, R_lanes.shape[0])
        seed_R, seed_t = icp_seeds(
            ubs, R_lanes, best_nodes, K, out=record.seeds(K, dev),
            reset=rec if i == 0 and len(todo) < n else None)
        r = icp_run(pair.data, pair.model, seed_R, seed_t,
                    **icp_kw(pair, cfg), enabled=enabled)
        score_pick(pair, cfg, r.R, r.t, r.nn_idx, cand_R, cand_t, rec, j)
    return rec


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


def initial_incumbent(pair: PairData, cfg: GoICPConfig) -> dict:
    """The initial incumbent (device_engine._initial_incumbent): ICP from
    the identity and, with cfg.init_seeds > 1, from K - 1 coarse
    rotations too, the best seed adopted where it beats the initial
    error.  On the card two launches (icp_run, score_initial) and no host
    read."""
    K = max(1, min(int(cfg.init_seeds), len(INIT_SEED_RV)))
    R0, t0 = init_seeds(K, pair.device)
    r = icp_run(pair.data, pair.model, R0, t0, **icp_kw(pair, cfg))
    return score_initial(pair, cfg, r.R, r.t, r.nn_idx)
