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
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from goicp_tpu_torch.chem.properties import compatibility_matrix
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.grid.lookup import dt_distance, nearest_cell_id
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.utils.fp32 import ordered_sum, rotate


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


def bnb_incompatibility_count(pair: PairData, cfg: GoICPConfig,
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


def score_transform(pair: PairData, cfg: GoICPConfig, R: torch.Tensor,
                    t: torch.Tensor, nn_idx: torch.Tensor) -> Score:
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
    bnb_count = bnb_incompatibility_count(pair, cfg, R, t)
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
    sc = score_transform(pair, cfg, res.R, res.t, res.nn_idx)
    *_, icp_incomp = icp_chem_terms(pair, cfg, res.nn_idx)
    return bnb_count, res, sc, icp_incomp


def initial_error(pair: PairData, cfg: GoICPConfig) -> torch.Tensor:
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
