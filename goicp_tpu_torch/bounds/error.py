"""Error scoring of full transforms (BnB/ICP-comparable DT error).

Port of goicp_tpu/bounds/error.py.  Mirrors GoICP::ICP re-scoring
(jly_goicp.cpp:102-178) and the initial error seeding (:597-626),
including the reference quirks:
  * trimmed ICP re-scoring drops the per-point weights and always squares
    (:135, :170-174), while the untrimmed path applies weights and the
    norm choice (:128-131);
  * the initial error at identity DOES weight before trimming (:604-613);
  * worst-case chem seeds: reg*Nd^2, regFPFH*800^2, regN*(6 Nd)^2 (:623-625).

Transforms may carry a leading batch axis: R (..., 3, 3), t (..., 3),
nn_idx (..., Nd) -> scores of shape (...).  Float sums and the rotated
points take utils/fp32.py's fixed order, the same on every device.

On the card each of score_transform (with icp_chem_terms' counts:
`rescore`), bnb_incompatibility_count and initial_error is one launch of
csrc/score.cu (`score_kernel`, counted in `score_kernel.launches`), whose
operations are the torch bodies' in their order; on the CPU they are
those torch bodies (`*_plain`), the same bits.  There is no other
fallback: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from goicp_tpu_torch.chem.properties import compatibility_matrix
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.grid.lookup import dt_distance, nearest_cell_id
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.utils.fp32 import (_launch, _on_card, _stream, kernels,
                                        ordered_sum, rotate)


class Score(NamedTuple):
    error: torch.Tensor
    geom: torch.Tensor
    incomp_term: torch.Tensor
    fpfh_term: torch.Tensor
    nbr_term: torch.Tensor
    incomp_count: torch.Tensor   # BnB-style count at the full transform


@functools.lru_cache(maxsize=None)
def _compat(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(compatibility_matrix(), device=device)


def _norm_sum(vals: torch.Tensor, norm: int) -> torch.Tensor:
    return ordered_sum(vals * vals) if norm == 2 else ordered_sum(vals)


def _transform(pair: PairData, R: torch.Tensor, t: torch.Tensor):
    return rotate(R, pair.data, t)


def trimmed_smallest(vals: torch.Tensor, inlier_num: int) -> torch.Tensor:
    """Keep the inlier_num smallest values (intro_select analogue)."""
    if inlier_num >= vals.shape[-1]:
        return vals
    return torch.sort(vals, dim=-1).values[..., :inlier_num]


def trimmed_smallest_dynamic(vals: torch.Tensor, k: torch.Tensor,
                             mask: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """k as a 0-d tensor: sort and zero everything past rank k (a where,
    not a multiply — dropped slots may hold +inf).  Padded slots must not
    be selectable: pass `mask` (truthy = real point) to force them to
    +inf here."""
    if mask is not None:
        vals = torch.where(mask, vals, torch.inf)
    vs = torch.sort(vals, dim=-1).values
    keep = torch.arange(vs.shape[-1], device=vs.device) < k
    return torch.where(keep, vs, torch.zeros_like(vs))


def icp_chem_terms(pair: PairData, cfg: GoICPConfig, nn_idx: torch.Tensor):
    """Chem regularization terms from ICP correspondences.
    Returns (nbr_term, incomp_term, fpfh_term, icp_incomp_count)."""
    compat = _compat(pair.device)
    mask = pair.data_mask
    nn_idx = nn_idx.long()
    incomp_pairs = ~compat.reshape(-1)[
        pair.data_props.long() * compat.shape[1]
        + pair.model_props.long()[nn_idx]]
    incomp = torch.sum(incomp_pairs.to(torch.float32) * mask, dim=-1)

    zero = torch.zeros_like(incomp)
    nbr_term = zero
    if cfg.regularizationNeighbors > 0:
        nbsum = torch.sum(torch.abs(pair.data_nbrs - pair.model_nbrs[nn_idx])
                          * mask, dim=-1).to(torch.float32)
        nbr_term = cfg.regularizationNeighbors * nbsum * nbsum

    incomp_term = zero
    if cfg.regularization > 0:
        incomp_term = cfg.regularization * incomp * incomp

    fpfh_term = zero
    if cfg.regularizationFPFH > 0 and cfg.cfpfh != 0:
        fp = ordered_sum(ordered_sum(torch.abs(pair.data_fpfh
                                               - pair.model_fpfh[nn_idx]))
                         * mask) / pair.nd_f()
        fpfh_term = cfg.regularizationFPFH * fp * fp
    return nbr_term, incomp_term, fpfh_term, incomp


def bnb_incompatibility_count_plain(pair: PairData, cfg: GoICPConfig,
                                    R: torch.Tensor, t: torch.Tensor):
    """GoICP::updateCompatibilities (jly_goicp.cpp:933-946): count of data
    points whose property is incompatible with their nearest occupied cell
    under the full transform."""
    pts = _transform(pair, R, t)
    cid = nearest_cell_id(pts, pair.grid.nearest_cell,
                          pair.grid.consts).long()
    n_cell = pair.compat_table.shape[1]
    rows = torch.arange(pair.n_data_padded, device=pts.device) * n_cell + cid
    comp = pair.compat_table.reshape(-1)[rows]
    return torch.sum((~comp).to(torch.float32) * pair.data_mask,
                     dim=-1).to(torch.int32)


def score_transform_plain(pair: PairData, cfg: GoICPConfig,
                          R: torch.Tensor, t: torch.Tensor,
                          nn_idx: torch.Tensor) -> Score:
    """GoICP::ICP re-scoring of a transform with DT distances + chem terms.
    nn_idx: ICP correspondences used for the chem terms."""
    pts = _transform(pair, R, t)
    d = dt_distance(pts, pair.grid.dist, pair.grid.consts)
    if cfg.doTrim:
        real = pair.data_mask > 0
        d = torch.where(real, d, torch.inf)
        kept = trimmed_smallest_dynamic(d, pair.inlier_f(), mask=real) \
            if pair.dynamic_counts \
            else trimmed_smallest(d, pair.inlier_num)  # unweighted (quirk)
        geom = ordered_sum(kept * kept)                # always squared (quirk)
    else:
        wd = pair.weights * d                          # padding weight == 0
        geom = _norm_sum(wd, cfg.norm)

    nbr_term, incomp_term, fpfh_term, _ = icp_chem_terms(pair, cfg, nn_idx)
    error = geom + nbr_term + incomp_term + fpfh_term
    bnb_count = bnb_incompatibility_count_plain(pair, cfg, R, t)
    return Score(error=error, geom=geom, incomp_term=incomp_term,
                 fpfh_term=fpfh_term, nbr_term=nbr_term,
                 incomp_count=bnb_count)


def refine_transform(pair: PairData, cfg: GoICPConfig, R0: torch.Tensor,
                     t0: torch.Tensor, *, max_iter: int,
                     with_bnb_count: bool = True):
    """The adopt-then-ICP path: BnB-style incompatibility count at (R0, t0),
    ICP refinement from it, DT re-scoring of the ICP result, and the ICP-
    correspondence incompatibility count.  R0 (3,3), t0 (3,).
    Returns (bnb_count, icp_result, score, icp_incomp_count), the ICP
    result and score with a leading axis of 1."""
    from goicp_tpu_torch.icp.icp import icp_run
    bnb_count = bnb_incompatibility_count(pair, cfg, R0, t0) \
        if with_bnb_count else torch.zeros((), dtype=torch.int32,
                                           device=pair.device)
    res = icp_run(pair.data, pair.model, R0[None], t0[None],
                  inlier_num=pair.inlier_num, max_iter=max_iter,
                  err_diff=cfg.err_diff,
                  data_mask=pair.data_mask if pair.padded else None,
                  count=pair.inlier_f() if pair.dynamic_counts else None,
                  dynamic_trim=pair.dynamic_counts and cfg.doTrim)
    sc, icp_incomp = rescore(pair, cfg, res.R, res.t, res.nn_idx)
    return bnb_count, res, sc, icp_incomp


def initial_error_plain(pair: PairData, cfg: GoICPConfig) -> torch.Tensor:
    """Initial incumbent at identity + worst-case chem seeds
    (jly_goicp.cpp:597-626)."""
    d = dt_distance(pair.data, pair.grid.dist, pair.grid.consts)
    wd = pair.weights * d                              # padding weight == 0
    if cfg.doTrim:
        real = pair.data_mask > 0
        wd = torch.where(real, wd, torch.inf)
        wd = trimmed_smallest_dynamic(wd, pair.inlier_f(), mask=real) \
            if pair.dynamic_counts else trimmed_smallest(wd, pair.inlier_num)
    err = _norm_sum(wd, cfg.norm)
    nd = pair.nd_f()
    if cfg.regularization > 0:
        err = err + cfg.regularization * nd * nd
    if cfg.regularizationFPFH > 0:
        err = err + cfg.regularizationFPFH * (800.0 * 800.0)
    if cfg.regularizationNeighbors > 0:
        err = err + cfg.regularizationNeighbors * (6.0 * nd) * (6.0 * nd)
    return err


# ---------------------------------------------------------------------------
# the card's route: csrc/score.cu
# ---------------------------------------------------------------------------

FULL, COUNT, INITIAL = 0, 1, 2     # the kernel's routes (csrc/score.cu)
# the pair's tensors the kernel reads, in its slot order (ScoreArgs)
_SLOTS = ("data", "weights", "data_mask", "dist", "nearest_cell", "consts",
          "data_props", "model_props", "compat", "data_nbrs", "model_nbrs",
          "data_fpfh", "model_fpfh", "compat_table", "counts")
_SLOT_TYPES = (torch.float32,) * 4 + (torch.int32, torch.float32,
                                      torch.int32, torch.int32, torch.bool,
                                      torch.int32, torch.int32,
                                      torch.float32, torch.float32,
                                      torch.bool, torch.float32)


def _slot_tensors(pair: PairData) -> tuple:
    g = pair.grid
    return (pair.data, pair.weights, pair.data_mask, g.dist, g.nearest_cell,
            g.consts, pair.data_props, pair.model_props, _compat(pair.device),
            pair.data_nbrs, pair.model_nbrs, pair.data_fpfh, pair.model_fpfh,
            pair.compat_table, pair.counts)


class _ScoreArgs(NamedTuple):
    tensors: tuple                  # what the slots point at (kept alive)
    slots: ctypes.Array             # c_ulonglong[15]
    ints: ctypes.Array              # c_int[13]
    floats: ctypes.Array            # c_float[4]


def _score_args(pair: PairData, cfg: GoICPConfig) -> _ScoreArgs:
    """The kernel's slot block for a pair and configuration, kept on the
    pair per configuration and used again while the pair holds the same
    tensors (a call checks them by identity)."""
    key = (cfg.norm, bool(cfg.doTrim), cfg.regularization,
           cfg.regularizationNeighbors, cfg.regularizationFPFH, cfg.cfpfh)
    cache = pair.__dict__.setdefault("_score_args", {})
    tensors = _slot_tensors(pair)
    got = cache.get(key)
    if got is not None and all(a is b for a, b in zip(got.tensors, tensors)):
        return got
    nd = pair.n_data_padded
    for name, x, dtype in zip(_SLOTS, tensors, _SLOT_TYPES):
        if x.dtype != dtype or not x.is_contiguous() or not x.is_cuda:
            raise ValueError(f"the rescoring kernel takes {name} as a "
                             f"contiguous {dtype} CUDA tensor, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if pair.data.shape != (nd, 3) or pair.compat_table.shape[0] != nd \
            or pair.data_fpfh.shape[0] != nd:
        raise ValueError(f"inconsistent pair shapes: data "
                         f"{tuple(pair.data.shape)}, compat_table "
                         f"{tuple(pair.compat_table.shape)}, data_fpfh "
                         f"{tuple(pair.data_fpfh.shape)}")
    trim = (2 if pair.dynamic_counts else 1) if cfg.doTrim else 0
    reg_f = cfg.regularizationFPFH
    ints = (nd, pair.compat_table.shape[1], tensors[8].shape[1],
            pair.data_fpfh.shape[1], int(cfg.norm), trim, pair.inlier_num,
            pair.n_data, int(pair.dynamic_counts),
            int(cfg.regularization > 0), int(cfg.regularizationNeighbors > 0),
            int(reg_f > 0 and cfg.cfpfh != 0), int(reg_f > 0))
    # the initial error's c-FPFH seed, a Python float as torch adds it
    floats = (cfg.regularization, cfg.regularizationNeighbors, reg_f,
              reg_f * (800.0 * 800.0))
    got = _ScoreArgs(tensors,
                     (ctypes.c_ulonglong * len(tensors))(
                         *(x.data_ptr() for x in tensors)),
                     (ctypes.c_int * len(ints))(*ints),
                     (ctypes.c_float * len(floats))(*floats))
    cache[key] = got
    return got


def _rows(x: torch.Tensor, shape: tuple, what: str) -> torch.Tensor:
    """x of this shape, contiguous (the kernel reads it row by row)."""
    if x.shape != shape:
        raise ValueError(f"the rescoring takes {what} of shape {shape}, got "
                         f"{tuple(x.shape)}")
    return x if x.is_contiguous() else x.contiguous()


def score_kernel(pair: PairData, cfg: GoICPConfig, mode: int,
                 R: torch.Tensor | None = None, t: torch.Tensor | None = None,
                 nn_idx: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of csrc/score.cu on the pair's card tensors.  mode FULL:
    R (..., 3, 3), t (..., 3), nn_idx (..., Nd) int64 or int32, the same
    leading dims (no broadcasting) -> (7, ...)
    float32, the rows error, geom, incomp_term, fpfh_term, nbr_term,
    incomp_count (int32 bits) and icp_incomp; COUNT: R, t -> (...) int32,
    the BnB counts; INITIAL: () float32, the initial error."""
    args = _score_args(pair, cfg)
    nn_ptr, wide = None, 0
    if mode == INITIAL:
        lead, rows = (), 1
        R_ptr = t_ptr = None
        out = pair.data.new_empty(())
    else:
        lead = tuple(R.shape[:-2])
        R, t = _rows(R, lead + (3, 3), "R"), _rows(t, lead + (3,), "t")
        R_ptr, t_ptr = R.data_ptr(), t.data_ptr()
        rows = R.numel() // 9
        if mode == FULL:
            nd = pair.n_data_padded
            if nn_idx.dtype not in (torch.int64, torch.int32):
                raise TypeError(f"nn_idx must be int64 or int32, got "
                                f"{nn_idx.dtype}")
            nn_idx = _rows(nn_idx, lead + (nd,), "nn_idx")
            nn_ptr, wide = nn_idx.data_ptr(), int(nn_idx.dtype is torch.int64)
            out = R.new_empty((7,) + lead)
        else:
            out = torch.empty(lead, dtype=torch.int32, device=R.device)
    if rows:
        _launch(kernels.goicp_score(args.slots, args.ints, args.floats, R_ptr,
                                    t_ptr, nn_ptr, wide, out.data_ptr(),
                                    rows, mode, _stream(pair.data)),
                "score")
        score_kernel.launches += 1
    return out


score_kernel.launches = 0


def rescore(pair: PairData, cfg: GoICPConfig, R: torch.Tensor,
            t: torch.Tensor, nn_idx: torch.Tensor):
    """(score_transform, icp_chem_terms' incompatibility count) of the
    transforms and their ICP correspondences: one launch of csrc/score.cu
    on the card, the torch bodies on the CPU."""
    if not _on_card(pair.data, R, t):
        return (score_transform_plain(pair, cfg, R, t, nn_idx),
                icp_chem_terms(pair, cfg, nn_idx)[3])
    out = score_kernel(pair, cfg, FULL, R, t, nn_idx).unbind(0)
    return (Score(error=out[0], geom=out[1], incomp_term=out[2],
                  fpfh_term=out[3], nbr_term=out[4],
                  incomp_count=out[5].view(torch.int32)), out[6])


def score_transform(pair: PairData, cfg: GoICPConfig, R: torch.Tensor,
                    t: torch.Tensor, nn_idx: torch.Tensor) -> Score:
    """score_transform_plain's Score: one launch of csrc/score.cu on the
    card (rescore's), the torch body on the CPU."""
    if not _on_card(pair.data, R, t):
        return score_transform_plain(pair, cfg, R, t, nn_idx)
    return rescore(pair, cfg, R, t, nn_idx)[0]


def bnb_incompatibility_count(pair: PairData, cfg: GoICPConfig,
                              R: torch.Tensor, t: torch.Tensor):
    """bnb_incompatibility_count_plain's int32 counts: one launch of
    csrc/score.cu on the card, the torch body on the CPU."""
    if not _on_card(pair.data, R, t):
        return bnb_incompatibility_count_plain(pair, cfg, R, t)
    return score_kernel(pair, cfg, COUNT, R, t)


def initial_error(pair: PairData, cfg: GoICPConfig) -> torch.Tensor:
    """initial_error_plain's value: one launch of csrc/score.cu on the
    card, the torch body on the CPU."""
    if not _on_card(pair.data):
        return initial_error_plain(pair, cfg)
    return score_kernel(pair, cfg, INITIAL)
