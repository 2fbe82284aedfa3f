"""Slot-packed cross-pair stream: kernel volume tracks ACTIVE work.

Port of goicp_tpu/search/packed_stream.py.  The fused stream
(search/fused_stream.py) advances every pair's full L-lane inner state each
global iteration, so done lanes and drained windows still pay full kernel
volume.  Here ALL (pair, lane) inner translation searches live in ONE flat
pool of W*L lanes, and each global iteration
  1. selects the S least-advanced LIVE lanes (S = cfg.packed_slots)
     across every pair — one stable argsort over W*L keys;
  2. gathers their frontier bundles; their pair's kernel tables are NOT
     gathered: the per-lane-table kernels K3 and K4 (bounds/cuda_eval.py)
     follow `lane_pair` to the per-pair tables;
  3. runs ONE inner-BnB iteration (search/inner.py::inner_step: one
     launch of csrc/inner.cu on the card) on the packed (S, ...) batch;
  4. scatters the updated bundles back.
Per-lane trajectories are those of the fused/device engines (each lane's
search depends only on its own state), so results match register_device
per pair; only scheduling changes.  A lone straggler automatically receives
every slot its own frontier can fill.

State packs into bundles so the hot path gathers and scatters few tensors:
sn (W,L,C,5) nodes+lbs, ss (W,L,16) scalars, pm (W,L,Nd,4) rotated points +
rot uncertainty, sv (W,L,C,8) the corner-reuse payload (pair-major so the
stream loop's window-refill row write stays valid; the hot loop uses flat
(W*L, ...) views).  Outer-step transitions unpack a row to the fused
engine's layout and reuse its harvest/ICP/advance logic.

Reference anchors: the one-node-at-a-time InnerBnB pops this batches are
jly_goicp.cpp:286-579; the pair loop bo1_GoICP.py:40-54.

Scope: chem == incompatibility-only (or off) and shapes inside the CUDA
kernels' envelope; other configs use the fused stream.  One device.
"""

from __future__ import annotations

import numpy as np
import torch

from goicp_tpu_torch.bounds import cuda_eval
from goicp_tpu_torch.bounds.evaluate import lane_tables, only_incomp
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.search import fused_stream as fs
from goicp_tpu_torch.search.device_engine import DeviceResult
from goicp_tpu_torch.search.inner import StepBuffers, inner_iteration

INF = float("inf")

# ss bundle layout (f32; integer-valued fields stay exact below 2^24)
_OPT, _THR, _MIND, _DONE, _IT, _EVALS = 0, 1, 2, 3, 4, 5
_BN = slice(6, 10)          # best_node (x,y,z,w)
_UBT = slice(10, 13)        # ub_terms (geom, incomp, fpfh)
_GSURV, _CHEMC = 13, 14     # per-lane geometric-survivor / chem-corner
                            # counters (see search/inner.InnerResult)
_SS_W = 16
_BUNDLES = ("sn", "ss", "pm", "sv")


def supports_packed(pair: PairData, cfg: GoICPConfig) -> bool:
    """Packed engine envelope: chem must be incompatibility-only (or off),
    and the shapes must be ones the CUDA kernels take."""
    if fs._chem_active(cfg) and not only_incomp(cfg):
        return False
    return cuda_eval.in_envelope(pair.n_data_padded,
                                 pair.grid.cell_coords.shape[-2],
                                 pair.grid.geom.size)


# ---------------------------------------------------------------------------
# state packing
# ---------------------------------------------------------------------------

def _pack_inner(inner: dict, pts_rot, mrd, lane_it, lane_evals,
                lane_gsurv, lane_chemc):
    """fused-style per-lane inner dict (..., L, ...) -> bundles.  Returns
    (sn, ss, pm, sv) where sv is the corner-reuse payload (..., L, C, 8T)
    or None when chem_reuse is off."""
    sn = torch.cat([inner["nodes"], inner["lbs"][..., None]], dim=-1)
    pad = torch.zeros(lane_it.shape + (_SS_W - 15,), dtype=torch.float32,
                      device=lane_it.device)
    ss = torch.cat([
        inner["opt_err"][..., None], inner["thr"][..., None],
        inner["min_dropped"][..., None],
        inner["done"].to(torch.float32)[..., None],
        lane_it[..., None], lane_evals[..., None],
        inner["best_node"], inner["ub_terms"],
        lane_gsurv[..., None], lane_chemc[..., None], pad], dim=-1)
    pm = torch.cat([pts_rot, mrd[..., None]], dim=-1)
    return sn, ss, pm, inner.get("cvals")


def _lane_dict(sn, ss, sv=None) -> dict:
    """Bundles -> the per-lane fields the inner body reads."""
    d = dict(nodes=sn[..., :4], lbs=sn[..., 4],
             opt_err=ss[..., _OPT], thr=ss[..., _THR],
             min_dropped=ss[..., _MIND], done=ss[..., _DONE] > 0,
             best_node=ss[..., _BN], ub_terms=ss[..., _UBT])
    if sv is not None:
        d["cvals"] = sv
    return d


def _inner_view(s: dict):
    """Packed bundles -> the fused engine's (W, L, ...) inner dict (plus
    pts_rot/mrd), for the transition path."""
    ss, pm = s["ss"], s["pm"]
    inner = _lane_dict(s["sn"], ss, s.get("sv"))

    def total(col):
        return torch.sum(ss[..., col], dim=1).to(torch.int32)

    # pair-level counters for the fused transition logic: SUMS over
    # lanes (the packed engine's inner_iters metric is total
    # lane-iterations — the work/volume unit — not sequential depth)
    inner.update(it=total(_IT), evals=total(_EVALS),
                 geom_surv=total(_GSURV), chem_corners=total(_CHEMC))
    return inner, pm[..., :3], pm[..., 3]


def _fused_state(s: dict) -> dict:
    """The packed state in the fused engine's layout."""
    inner, pts_rot, mrd = _inner_view(s)
    fstate = {k: v for k, v in s.items() if k not in _BUNDLES}
    fstate.update(inner=inner, pts_rot=pts_rot, mrd=mrd)
    return fstate


def _repack(fstate: dict) -> dict:
    """A fused-layout state (one row or a window) with FRESH lane counters
    -> the packed layout."""
    out = dict(fstate)
    inner = out.pop("inner")
    zeros = torch.zeros(inner["done"].shape, dtype=torch.float32,
                        device=inner["done"].device)
    sn, ss, pm, sv = _pack_inner(inner, out.pop("pts_rot"), out.pop("mrd"),
                                 zeros, zeros, zeros, zeros)
    out.update(sn=sn, ss=ss, pm=pm)
    if sv is not None:
        out["sv"] = sv
    return out


def packed_init(pair_batch: PairData, cfg: GoICPConfig) -> dict:
    """Batched fused init, repacked into slot bundles.  inner_it counts
    total lane-iterations executed (the packed engine's volume metric)."""
    return _repack(fs._init_batch(pair_batch, cfg))


# ---------------------------------------------------------------------------
# the packed inner iteration
# ---------------------------------------------------------------------------

def _packed_iter(cfg: GoICPConfig, tables, sn, ss, pm, live, sv=None,
                 bufs=None):
    """One inner-BnB iteration on S packed lanes (possibly from different
    pairs; tables.lane_pair says which): one inner step
    (search/inner.py::inner_step, one launch on the card) over the bundles
    unpacked into the step's fields, then repacked.  Dead slots (padding
    when fewer than S lanes are live) keep their state.  sv (S,C,8): the
    corner-reuse payload rows when cfg.chem_reuse; bufs the loop's
    inner.StepBuffers."""
    lanes = {k: v.contiguous() for k, v in _lane_dict(sn, ss, sv).items()}
    new, _, stats = inner_iteration(
        tables, cfg, lanes, pm[..., :3].contiguous(),
        pm[..., 3].contiguous(), True, live=live, groups=live.shape[0],
        bufs=bufs)
    done = new["done"]
    sn_new = torch.cat([new["nodes"], new["lbs"][..., None]], dim=-1)
    ss_new = torch.cat([
        new["opt_err"][:, None], new["thr"][:, None],
        new["min_dropped"][:, None], done.to(torch.float32)[:, None],
        (ss[:, _IT] + torch.where(done, 0.0, 1.0))[:, None],
        (ss[:, _EVALS] + stats.evals)[:, None],
        new["best_node"], new["ub_terms"],
        (ss[:, _GSURV] + stats.geom_surv)[:, None],
        (ss[:, _CHEMC] + float(stats.corners_per_lane))[:, None],
        ss[:, 15:]], dim=-1)
    # the step kept the dead slots' lanes; their counters stay too
    ss_new = torch.where(live[:, None], ss_new, ss)
    return sn_new, ss_new, new.get("cvals")


# ---------------------------------------------------------------------------
# transitions (reuse the fused engine's logic on an unpacked view)
# ---------------------------------------------------------------------------

def _transition(pair_batch: PairData, cfg: GoICPConfig, s: dict, rows):
    """Transition the window rows `rows` in place: the fused engine's
    per-row transition on the unpacked view, repacked with the rows' lane
    counters reset."""
    new_rows = fs._transition_batch(pair_batch, cfg, _fused_state(s), rows)
    for r, new in zip(rows, new_rows):
        fs._write_row(s, int(r), _repack(new))


def _lane_over(s: dict, cfg: GoICPConfig) -> torch.Tensor:
    """(W, L) lanes whose inner search is over (done, or at the cap)."""
    ss = s["ss"]
    return (ss[..., _DONE] > 0) | (ss[..., _IT] >= cfg.inner_max_iters)


def packed_run_chunk(pair_batch: PairData, cfg: GoICPConfig, state: dict,
                     steps: int) -> dict:
    """Advance the packed pool by at most `steps` global iterations
    (`state` itself is not modified).  One host read per iteration: which
    pairs are live, which completed their inner phase, and whether live
    lanes can still fill the slot budget."""
    s = fs._map_state(torch.clone, state)
    W, L = s["active"].shape
    WL = W * L
    S = min(cfg.packed_slots, WL)
    TE = max(1, cfg.packed_trans_every)
    K = fs._trans_budget(cfg, W)
    tables = lane_tables(pair_batch, cfg)
    far = torch.tensor(float(2 ** 30), device=s["ss"].device)
    bufs = StepBuffers()

    def lane_live_of(live_pair):
        return ~_lane_over(s, cfg).reshape(WL) \
            & live_pair.repeat_interleave(L)

    g = 0
    while True:
        live_pair = ~s["converged"] & (s["it"] < cfg.max_outer_steps)
        lane_live = lane_live_of(live_pair)
        pair_done = torch.all(_lane_over(s, cfg), dim=1)
        flags = torch.cat([live_pair, pair_done,
                           (torch.sum(lane_live) < S)[None]]).cpu().numpy()
        fs.counters["host_reads"] += 1
        if not (bool(flags[:W].any()) and g < steps):
            break
        # transition batching: fire the (expensive) harvest/ICP/advance
        # block only every TE iterations — completed phases idle while
        # other pairs' lanes fill the slots — UNLESS live lanes can no
        # longer fill the slot budget (endgame / straggler: then
        # transition immediately, no added latency)
        if g % TE == 0 or flags[2 * W]:
            rows = np.nonzero(flags[W:2 * W] & flags[:W])[0][:K]
            if len(rows):
                _transition(pair_batch, cfg, s, rows)
                live_pair = ~s["converged"] \
                    & (s["it"] < cfg.max_outer_steps)
                lane_live = lane_live_of(live_pair)

        # ---- slot selection: S least-advanced live lanes (flat views of
        # the pair-major bundles) ----
        snf = s["sn"].reshape((WL,) + s["sn"].shape[2:])
        ssf = s["ss"].reshape(WL, _SS_W)
        pmf = s["pm"].reshape((WL,) + s["pm"].shape[2:])
        svf = s["sv"].reshape((WL,) + s["sv"].shape[2:]) \
            if "sv" in s else None
        key = torch.where(lane_live, ssf[:, _IT], far)
        slots = torch.argsort(key, stable=True)[:S]           # (S,)
        spair = (slots // L).to(torch.int32)
        live = lane_live[slots]

        sn_n, ss_n, sv_n = _packed_iter(
            cfg, tables._replace(lane_pair=spair), snf[slots], ssf[slots],
            pmf[slots], live, sv=svf[slots] if svf is not None else None,
            bufs=bufs)
        snf.index_copy_(0, slots, sn_n)
        ssf.index_copy_(0, slots, ss_n)
        if sv_n is not None:
            svf.index_copy_(0, slots, sv_n)
        g += 1
        fs.counters["global_iters"] += 1
    return s


def packed_finalize(state: dict) -> DeviceResult:
    """Identical gap semantics to fused_finalize (incl. the in-flight
    inner lower-bound fold), via the unpacked view."""
    res = fs.fused_finalize(_fused_state(state))
    # inner_iters: total lane-iterations (the packed work metric) =
    # retired phases (accumulated at transitions) + in-flight lanes
    inflight = torch.sum(state["ss"][..., _IT], dim=1).to(torch.int32)
    return res._replace(inner_iters=res.inner_iters + inflight)


def _packed_inflight_np(state) -> np.ndarray:
    """(W,) in-flight inner lower bound from the packed bundles, on the
    host (progress telemetry; mirrors fused_stream._fused_inflight_np)."""
    return fs._fused_inflight_np(_fused_state(state))


def register_packed_stream(pairs, cfg: GoICPConfig, width: int = 8,
                           chunk_steps: int = 256, progress=None,
                           checkpoint_path: str | None = None,
                           resume: bool = False,
                           max_chunks: int | None = None,
                           checkpoint_every: int = 1):
    """Continuous-batching registration over the packed engine (same
    windowing, checkpoint, and refill semantics as
    register_fused_stream), on the device of the pairs it is given."""
    if not supports_packed(pairs[0], cfg):
        raise ValueError("packed stream requires incomp-only (or no) chem "
                         "terms and shapes inside the CUDA kernels' "
                         "envelope; use register_fused_stream")
    return fs._stream_driver(
        pairs, cfg, width=width, chunk_steps=chunk_steps,
        progress=progress, checkpoint_path=checkpoint_path, resume=resume,
        max_chunks=max_chunks,
        init_fn=packed_init, run_chunk=packed_run_chunk,
        finalize=packed_finalize, inflight_fn=_packed_inflight_np,
        checkpoint_every=checkpoint_every)
