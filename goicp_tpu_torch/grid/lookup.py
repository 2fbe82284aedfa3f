"""Batched distance-transform lookups (the bound path's gather).

Port of goicp_tpu/grid/lookup.py.  Reference semantics (DT3D::Distance,
jly_3ddt.cpp:1139-1191):
  * voxel = ROUND((p - min) * scale) per axis (trunc(x+0.5));
  * in-bounds: field value at the voxel;
  * out-of-bounds: per-axis excess a = idx (if idx<0) or idx-SIZE+1 (if
    idx>=SIZE); result = sqrt(a^2+b^2+c^2)/scale + field at the clamped voxel.

Chem lookups (GoICP::checkCompatibility, jly_goicp.cpp:974-984) use the
CLAMPED voxel directly (no excess term) to find the nearest occupied cell.
The grid size is read from consts[4] as a tensor, so no lookup syncs with
the host.  Shapes: points (..., 3) -> outputs (...,).
"""

from __future__ import annotations

import torch

from goicp_tpu_torch.grid.edt import exact_sqrt, round_ref


def voxel_indices(points: torch.Tensor, consts: torch.Tensor):
    """points (..., 3) -> (raw int idx (..., 3), clamped idx (..., 3))."""
    lo = consts[0:3]
    scale = consts[3]
    size = consts[4].to(torch.int32)
    raw = round_ref((points - lo) * scale)
    clamped = torch.minimum(torch.clamp(raw, min=0), size - 1)
    return raw, clamped


def flat_index(idx: torch.Tensor, consts: torch.Tensor) -> torch.Tensor:
    """(..., 3) voxel coords -> (...,) int64 flat index (z*S + y)*S + x."""
    size = consts[4].to(torch.int64)
    idx = idx.to(torch.int64)
    return (idx[..., 2] * size + idx[..., 1]) * size + idx[..., 0]


def oob_extension(raw: torch.Tensor, consts: torch.Tensor):
    """Raw voxels (..., 3) -> (out of bounds (...,) bool, the extension
    sqrt(a^2+b^2+c^2)/scale (...,))."""
    size = consts[4].to(torch.int32)
    below = raw.to(torch.float32)                     # a = idx when idx < 0
    above = (raw - size + 1).to(torch.float32)        # a = idx-SIZE+1
    zero = torch.zeros_like(below)
    excess = torch.where(raw < 0, below, torch.where(raw >= size, above, zero))
    oob = torch.any((raw < 0) | (raw >= size), dim=-1)
    # (a^2 + b^2) + c^2 written out: the sequential order XLA:CPU and the
    # CPU's torch.sum take over three terms; torch.sum leaves the order to
    # the device's library (csrc/score.cu and the bound kernels take this
    # one)
    sq = excess * excess
    return oob, exact_sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2]) / consts[3]


def dt_distance(points: torch.Tensor, dist_field: torch.Tensor,
                consts: torch.Tensor) -> torch.Tensor:
    """DT3D::Distance for a batch of points (..., 3) -> (...,)."""
    raw, clamped = voxel_indices(points, consts)
    base = dist_field[flat_index(clamped, consts)]
    oob, extra = oob_extension(raw, consts)
    return torch.where(oob, base + extra, base)


def nearest_cell_id(points: torch.Tensor, nearest_field: torch.Tensor,
                    consts: torch.Tensor) -> torch.Tensor:
    """Clamped-voxel gather of the nearest occupied cell index (...,)."""
    _, clamped = voxel_indices(points, consts)
    return nearest_field[flat_index(clamped, consts)]
