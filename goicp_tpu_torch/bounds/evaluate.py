"""Batched translation-node bound evaluation.

Port of goicp_tpu/bounds/evaluate.py.  Evaluates (lanes x nodes x points)
in one shot:
  pos   = rotated_points[lane] + center[lane, node]
  dis   = weights * DT(pos)
  minDis= clamp(dis - rot_uncertainty[lane], 0)
  trim  = K smallest per node
  ub    = sum f(minDis);  lb = sum f(clamp(minDis - sqrt(3)/2 w, 0))
and chem corner terms over the 27-point corner lattice a parent's 8
children share.

Routing, by the device of the tensors: CUDA tensors go to the kernels of
bounds/cuda_eval.py (the geometric bounds always; the chem counts when the
incompatibility term is the only chem term, where the JAX package uses its
chem kernel).  CPU tensors take the gather path over the EDT fields, which
is what the JAX package runs on the CPU.  FPFH and neighbour terms take
the gather path on both devices.

The cross-pair streams evaluate lanes of DIFFERENT pairs in one call: they
pass a LaneTables (per-pair tables plus the pair of each lane) where a
PairData is expected, and the call goes to the per-lane-table kernels K3
and K4 of bounds/cuda_eval.py (their plain versions on the CPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.bounds import cuda_eval
from goicp_tpu_torch.bounds.cuda_eval import reduce_bounds
from goicp_tpu_torch.grid.lookup import (dt_distance, flat_index,
                                         nearest_cell_id, voxel_indices)
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.utils.fp32 import (_on_card, dot3, ordered_sum,
                                        rot_uncertainty_kernel,
                                        sincos32_plain)

SQRT3 = float(np.sqrt(3.0))

# match reference child ordering: x from bit0, y from bit1, z from bit2
_CHILD_OFFSETS = np.array([[j & 1, (j >> 1) & 1, (j >> 2) & 1]
                           for j in range(8)])
_LATTICE_OFFSETS = np.array([[a, b, c] for c in range(3) for b in range(3)
                             for a in range(3)])  # 27 x 3, x fastest
# child j has corners c at lattice position (jx+cx, jy+cy, jz+cz) in the
# 3x3x3 corner lattice of its parent (offsets in units of child width)
_CHILD_CORNER_TO_LATTICE = np.zeros((8, 8), dtype=np.int64)
for _j in range(8):
    for _c in range(8):
        _off = _CHILD_OFFSETS[_j] + _CHILD_OFFSETS[_c]
        _CHILD_CORNER_TO_LATTICE[_j, _c] = \
            (_off[2] * 3 + _off[1]) * 3 + _off[0]


class LaneTables(NamedTuple):
    """What K3 and K4 read: the tables of W stacked pairs and, for each of
    the L lanes of a call, the pair it belongs to."""
    weights: torch.Tensor       # (W, Nd)
    cell_coords: torch.Tensor   # (W, C, 3) i32
    nearest_cell: torch.Tensor  # (W, S^3) i32 row of cell_coords per voxel
    consts: torch.Tensor        # (W, 5)
    trim_count: torch.Tensor | None   # (W,) inlier counts, None = no trim
    cell_compat: torch.Tensor   # (W, C, 9)
    prop_onehot: torch.Tensor   # (W, Nd, 9)
    data_mask: torch.Tensor     # (W, Nd)
    sse: torch.Tensor           # (W,) the search epsilon of each pair
    lane_pair: torch.Tensor | None    # (L,) i32; None: every lane pair 0
    size: int
    trim_k: int = 0             # static K (one pair of static counts)


def only_incomp(cfg: GoICPConfig) -> bool:
    """The incompatibility count is the only active chem term."""
    return (cfg.regularization > 0
            and not (cfg.regularizationFPFH > 0 and cfg.cfpfh != 0)
            and cfg.regularizationNeighbors <= 0)


def lane_tables(pair_batch: PairData, cfg: GoICPConfig,
                lane_pair: torch.Tensor | None = None) -> LaneTables:
    """Per-pair kernel tables of a stacked PairData (dist/mesh.stack_pairs).
    The trim count is each pair's inlier count, read on the device."""
    p = pair_batch
    inliers = p.counts[:, 1].contiguous()
    sse = torch.tensor(cfg.mse_margin, dtype=torch.float32,
                       device=p.device) * inliers
    return LaneTables(
        weights=p.weights, cell_coords=p.grid.cell_coords,
        nearest_cell=p.grid.nearest_cell, consts=p.grid.consts,
        trim_count=inliers if cfg.doTrim else None,
        cell_compat=p.cell_compat, prop_onehot=p.prop_onehot,
        data_mask=p.data_mask, sse=sse, lane_pair=lane_pair,
        size=p.grid.geom.size)


def one_pair_tables(pair: PairData, cfg: GoICPConfig) -> LaneTables:
    """The LaneTables of ONE pair (W = 1, lane_pair None: every lane reads
    pair 0) in the pair's trim mode, for the inner step kernel of the
    one-pair engines.  Built once per pair, epsilon and trim switch, and
    kept on the pair: its views and the (1,) epsilon cost no launch after
    the first outer step."""
    key = (cfg.mse_margin, bool(cfg.doTrim))
    cache = pair.__dict__.setdefault("_one_pair_tables", {})
    if key not in cache:
        trim = _trim_mode(pair, cfg)
        g = pair.grid
        sse = torch.tensor(cfg.mse_margin, dtype=torch.float32,
                           device=pair.device) * pair.inlier_f()
        cache[key] = LaneTables(
            weights=pair.weights[None], cell_coords=g.cell_coords[None],
            nearest_cell=g.nearest_cell[None], consts=g.consts[None],
            trim_count=pair.counts[1:2] if trim == "dynamic" else None,
            cell_compat=pair.cell_compat[None],
            prop_onehot=pair.prop_onehot[None],
            data_mask=pair.data_mask[None], sse=sse.reshape(1),
            lane_pair=None, size=g.geom.size,
            trim_k=pair.inlier_num if trim == "static" else 0)
    return cache[key]


def _trim_mode(pair: PairData, cfg: GoICPConfig) -> str:
    """'off' | 'static' (inlier_num) | 'dynamic' (counts[1]).  In
    dynamic_counts mode inlier_num is the padded size, so the trim decision
    comes from the config."""
    if pair.dynamic_counts:
        return "dynamic" if cfg.doTrim else "off"
    return "static" if pair.inlier_num < pair.n_data else "off"


def _gather_dis(pair: PairData, pts_rot, centers):
    pos = pts_rot[:, None, :, :] + centers[:, :, None, :]   # (L,B,Nd,3)
    return pair.weights[None, None, :] * dt_distance(
        pos, pair.grid.dist, pair.grid.consts)              # (L,B,Nd)


def _bounds(pair: PairData, cfg: GoICPConfig, pts_rot, centers, widths,
            rot_uncertainty, fused: bool):
    trim = _trim_mode(pair, cfg)
    if pts_rot.is_cuda:
        return cuda_eval.geometric_bounds_kernel(
            pts_rot.contiguous(), centers.contiguous(), widths.contiguous(),
            None if rot_uncertainty is None else rot_uncertainty.contiguous(),
            pair.weights, pair.grid.cell_coords, pair.grid.nearest_cell,
            pair.grid.consts,
            trim_count=pair.inlier_f() if trim == "dynamic" else None,
            size=pair.grid.geom.size, norm=cfg.norm, fused=fused,
            trim_k=pair.inlier_num if trim == "static" else 0)
    dis = _gather_dis(pair, pts_rot, centers)
    mask = pair.data_mask[None, None, :] > 0
    if trim == "dynamic":
        return reduce_bounds(dis, widths, rot_uncertainty, cfg.norm, fused,
                             mask=mask, k=pair.inlier_f())
    if trim == "static":
        return reduce_bounds(dis, widths, rot_uncertainty, cfg.norm, fused,
                             mask=mask, k=pair.inlier_num, static=True)
    # no trimming: padding points contribute exactly 0 to every sum
    return reduce_bounds(dis, widths, rot_uncertainty, cfg.norm, fused)


def geometric_bounds(pair: PairData, cfg: GoICPConfig, pts_rot, centers,
                     widths, rot_uncertainty):
    """pts_rot (L, Nd, 3); centers (L, B, 3); widths (L, B);
    rot_uncertainty (L, Nd) or None -> (ub (L,B), lb (L,B))."""
    return _bounds(pair, cfg, pts_rot, centers, widths, rot_uncertainty,
                   fused=False)


def geometric_bounds_fused(pair: PairData, cfg: GoICPConfig, pts_rot,
                           centers, widths, rot_uncertainty):
    """One DT lookup, three bounds (the fused inner-search evaluator):
      ub_plain: error at the node center with zero rotation uncertainty;
      ubu:      same with maxRotDis subtracted;
      lbu:      ubu minus the sqrt(3)/2*w translation uncertainty.
    -> three (L,B) tensors.  `pair` may be a LaneTables."""
    if isinstance(pair, LaneTables):
        t = pair
        return cuda_eval.geometric_bounds_kernel_lanes(
            pts_rot.contiguous(), centers.contiguous(), widths.contiguous(),
            rot_uncertainty.contiguous(), t.weights, t.cell_coords,
            t.nearest_cell, t.consts, t.trim_count, t.lane_pair,
            size=t.size, norm=cfg.norm)
    return _bounds(pair, cfg, pts_rot, centers, widths, rot_uncertainty,
                   fused=True)


def chem_corner_values(pair: PairData, cfg: GoICPConfig, pts_rot, corners):
    """Per-corner chem sums.  pts_rot (L, Nd, 3); corners (L, Q, 3) ->
    dict of (L, Q) tensors: incomp (count), fpfh (mean over Nd), nbr (sum),
    all through the nearest occupied cell of the clamped voxel.  `pair`
    may be a LaneTables when the count is the only chem term."""
    if isinstance(pair, LaneTables):
        if not only_incomp(cfg):
            raise ValueError("per-lane tables carry the incompatibility "
                             "count only")
        t = pair
        return {"incomp": cuda_eval.chem_incomp_kernel_lanes(
            pts_rot.contiguous(), corners.contiguous(), t.cell_compat,
            t.prop_onehot, t.data_mask, t.nearest_cell, t.consts,
            t.lane_pair, size=t.size)}
    if only_incomp(cfg) and pts_rot.is_cuda:
        return {"incomp": cuda_eval.chem_incomp_kernel(
            pts_rot.contiguous(), corners.contiguous(), pair.cell_compat,
            pair.prop_onehot, pair.data_mask, pair.grid.nearest_cell,
            pair.grid.consts, size=pair.grid.geom.size)}
    pos = pts_rot[:, None, :, :] + corners[:, :, None, :]   # (L,Q,Nd,3)
    nd_idx = torch.arange(pair.n_data_padded, device=pos.device)[None, None]
    out = {}
    cid = None
    if pair.fused_chem:
        # one gather per (corner, point) against per-voxel tables
        _, clamped = voxel_indices(pos, pair.grid.consts)
        flat = flat_index(clamped, pair.grid.consts)        # (L,Q,Nd)
        s3 = pair.comp_voxel.shape[1]
        rows = nd_idx * s3 + flat
        if cfg.regularization > 0:
            comp = pair.comp_voxel.reshape(-1)[rows]
            out["incomp"] = torch.sum(~comp, dim=-1).to(torch.float32)
        if cfg.regularizationFPFH > 0 and cfg.cfpfh != 0:
            fp = pair.fpfh_voxel.reshape(-1)[rows]
            out["fpfh"] = ordered_sum(fp) / pair.nd_f()
        if cfg.regularizationNeighbors > 0:
            cid = nearest_cell_id(pos, pair.grid.nearest_cell,
                                  pair.grid.consts)
    else:
        cid = nearest_cell_id(pos, pair.grid.nearest_cell,
                              pair.grid.consts).long()      # (L,Q,Nd)
        rows = nd_idx * pair.compat_table.shape[1] + cid
        if cfg.regularization > 0:
            comp = pair.compat_table.reshape(-1)[rows]
            out["incomp"] = torch.sum(~comp, dim=-1).to(torch.float32)
        if cfg.regularizationFPFH > 0 and cfg.cfpfh != 0:
            fp = pair.fpfh_table.reshape(-1)[rows]
            out["fpfh"] = ordered_sum(fp) / pair.nd_f()
    if cfg.regularizationNeighbors > 0:
        # nearest model point within the nearest occupied cell (argmin of
        # true distances over the cell's padded point list)
        cpts = pair.grid.cell_points.long()[cid.long()]     # (L,Q,Nd,K)
        valid = cpts >= 0
        mpts = pair.model[torch.clamp(cpts, min=0)]         # (L,Q,Nd,K,3)
        diff = pos[..., None, :] - mpts
        d2 = dot3(diff, diff)
        d2 = torch.where(valid, d2, torch.inf)
        k_best = torch.argmin(d2, dim=-1)                   # (L,Q,Nd)
        nn_pt = torch.gather(cpts, -1, k_best[..., None])[..., 0]
        diff = torch.abs(pair.data_nbrs[None, None, :]
                         - pair.model_nbrs[torch.clamp(nn_pt, min=0)])
        out["nbr"] = torch.sum(diff * pair.data_mask[None, None, :],
                               dim=-1).to(torch.float32)
    return out


def chem_bounds_from_lattice(cfg: GoICPConfig, lattice_vals: dict,
                             with_child_vals: bool = False):
    """lattice_vals: dict of (L, P, 27) corner values ->
    (ub_add (L,P,8), lb_add (L,P,8), ub_terms dict of (L,P,8)).

    Per child, max/min over its 8 corners, weighted by the regularization
    (jly_goicp.cpp:536-549).  with_child_vals=True also returns the
    per-child 8-corner raw values, dict of (L,P,8,8): the corner-reuse
    payload stored with each inserted child."""
    ub_add = 0.0
    lb_add = 0.0
    ub_terms = {}
    child_vals = {}
    for key, reg in (("incomp", cfg.regularization),
                     ("fpfh", cfg.regularizationFPFH),
                     ("nbr", cfg.regularizationNeighbors)):
        if key not in lattice_vals:
            continue
        v = lattice_vals[key]
        gather = torch.as_tensor(_CHILD_CORNER_TO_LATTICE.reshape(-1),
                                 device=v.device)
        vals = v[..., gather]                               # (L,P,64)
        vals = vals.reshape(vals.shape[:-1] + (8, 8))       # (L,P,8c,8corner)
        if with_child_vals:
            child_vals[key] = vals
        vmax = torch.amax(vals, dim=-1)
        vmin = torch.amin(vals, dim=-1)
        ub_t = reg * vmax * vmax
        ub_add = ub_add + ub_t
        lb_add = lb_add + reg * vmin * vmin
        ub_terms[key] = ub_t
    if with_child_vals:
        return ub_add, lb_add, ub_terms, child_vals
    return ub_add, lb_add, ub_terms


def rot_uncertainty(widths: torch.Tensor, norm_data: torch.Tensor):
    """maxRotDis for rotation cubes of width w (L,) -> (L, Nd)
    (jly_goicp.cpp:185-206): 2 sin(min(sqrt(3) w/2, pi)/2) * ||p||.  One
    launch of csrc/fp32_products.cu on CUDA float32 tensors
    (utils/fp32.py's rot_uncertainty_kernel: a thread an output,
    rot_uncertainty_plain's seven steps in their order);
    rot_uncertainty_plain on CPU tensors."""
    if _on_card(widths, norm_data):
        return rot_uncertainty_kernel(widths, norm_data)
    return rot_uncertainty_plain(widths, norm_data)


def rot_uncertainty_plain(widths: torch.Tensor, norm_data: torch.Tensor):
    """rot_uncertainty in elementwise torch ops, float32: float(sqrt 3) w,
    / 2, clamp(max=float(pi)) (a NaN stays), / 2, sincos32's sine, 2 s,
    times norm_data[j]."""
    angle = torch.clamp(SQRT3 * widths / 2.0, max=math.pi)
    return 2.0 * sincos32_plain(angle / 2.0)[0][:, None] \
        * norm_data[None, :]
