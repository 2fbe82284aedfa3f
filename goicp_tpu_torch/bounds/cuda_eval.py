"""The bound-evaluation kernels (CUDA, sm_90a) and their plain versions.

Port of goicp_tpu/bounds/pallas_eval.py's four kernels:

  K1 geometric_bounds_kernel        <- :517 (csrc/geom_bounds.cu)
  K2 chem_incomp_kernel             <- :702 (csrc/chem_incomp.cu)
  K3 geometric_bounds_kernel_lanes  <- :632 (csrc/geom_bounds.cu)
  K4 chem_incomp_kernel_lanes       <- :778 (csrc/chem_incomp.cu)

The TPU kernels recompute the exact-EDT lookup as a minimum over the
occupied cells, because a gather is what a TPU does badly.  Here every
kernel reads the pair's nearest-cell table instead (`Grid.nearest_cell`,
(S^3,) int32: the EDT's own first-minimum argmin over the cells, built by
grid/edt.py::nearest_occupied): per point one voxelization, one table read
and, for the geometric bounds, one integer squared distance to that cell,
which is the same minimum, so every per-point distance keeps its bits.
K1 keeps the TPU kernel's signature (minus `interpret`) plus that table;
K2 takes the table in place of the cell coordinates, which the count no
longer reads.  K3 and K4 are K1 (fused mode) and K2 for lane batches whose lanes
belong to different pairs (the cross-pair streams): they take the PER-PAIR
tables with a leading pair axis plus `lane_pair` (L,) int32, and each lane
reads the rows of its own pair.  (The TPU versions take gathered per-lane
copies of the tables, which a Pallas block spec needs and a CUDA block
does not.)

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor goes to the plain torch version beside it (geometric_bounds_plain,
chem_incomp_plain, geometric_bounds_lanes_plain, chem_incomp_lanes_plain),
a CUDA tensor to the kernel, which launches on the current stream or
raises.  There is no other fallback.  Each wrapper
counts its kernel launches in its `launches` attribute.

Nothing here builds or needs nvcc until a kernel is launched.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from goicp_tpu_torch.grid.edt import exact_sqrt
from goicp_tpu_torch.grid.lookup import (flat_index, oob_extension,
                                         voxel_indices)
from goicp_tpu_torch.icp.icp import icp_run, kabsch3
from goicp_tpu_torch.utils.fp32 import (cross3, det3, dot_fma, norm3,
                                        ordered_sum, rodrigues_kernel,
                                        rot_uncertainty_kernel, rotate,
                                        sincos32, sq_dist3)

SQRT3 = float(np.sqrt(3.0))
MAX_POINTS = 8192     # points per row: two trimmed rows fit a block's memory
MAX_SIZE = 1024       # grid size: voxels pack 10 bits per axis


# ---------------------------------------------------------------------------
# plain torch versions (same functions, same inputs)
# ---------------------------------------------------------------------------

def _sum_k_smallest(vals, mask, k, static: bool, fs):
    """K1/K3's trimmed sums (geom_bounds.cu::sum_k_smallest) of each row of
    vals (L,B,Nd): the K-th smallest real value kth (padding forced to
    +inf), then for each function g of fs the sum of g(v) over the values
    strictly below it, in K1/K3's order (utils/fp32.py::ordered_sum), plus
    (K - their count) copies of g(kth).  K: static k, clipped to Nd, or
    from a 0-d tensor k on the device: 0 unless k > 0, Nd when k >= Nd,
    else ceil(k); a row with K = 0 sums to 0."""
    vals = torch.where(mask, vals, torch.inf)
    nd = vals.shape[-1]
    srt = torch.sort(vals, dim=-1).values
    if static:
        K = min(int(k), nd)
        kth = srt[..., K - 1:K]
    else:
        kf = k.to(torch.float32)
        K = torch.where(kf > 0, torch.where(kf >= nd, float(nd),
                                            torch.ceil(kf)),
                        0.0).to(torch.int64)
        idx = torch.clamp(K - 1, min=0).expand(srt.shape[:-1] + (1,))
        kth = torch.gather(srt, -1, idx)
    below = vals < kth
    zero = torch.zeros_like(vals)
    ties = (K - torch.sum(below, dim=-1)).to(torch.float32)
    out = []
    for g in fs:
        s = ordered_sum(torch.where(below, g(vals), zero)) \
            + ties * g(kth)[..., 0]
        out.append(s if static else torch.where(K > 0, s, 0.0))
    return out


def reduce_bounds(dis, widths, rot_unc, norm: int, fused: bool,
                  mask=None, k=None, static: bool = False):
    """Per-node bound sums from per-point weighted distances, in K1/K3's
    order: every sum over the Nd points is utils/fp32.py::ordered_sum
    (lanes 32), the trimmed ones _sum_k_smallest, so that the kernels
    and this function agree bit for bit.

    dis (L,B,Nd) = w * d; widths (L,B); rot_unc (L,Nd) or None; trimming
    when k is given (static k, or a 0-d tensor k read on the device; mask
    (…,Nd) bool marks real points).  Returns (ub, lb) or, fused,
    (ub_plain, ubu, lbu), each (L,B)."""
    def f(v):
        return v * v if norm == 2 else v

    s3w = ((SQRT3 / 2.0) * widths)[:, :, None]

    def lbf(v):
        return f(torch.clamp(v - s3w, min=0.0))

    def sums(v, *fs):
        if k is None:
            return [ordered_sum(g(v)) for g in fs]
        return _sum_k_smallest(v, mask, k, static, fs)

    if fused:
        disu = torch.clamp(dis if rot_unc is None
                           else dis - rot_unc[:, None, :], min=0.0)
        return (*sums(dis, f), *sums(disu, f, lbf))
    if rot_unc is not None:
        dis = dis - rot_unc[:, None, :]
    return tuple(sums(torch.clamp(dis, min=0.0), f, lbf))


def point_distances(pts_rot, centers, cell_coords, nearest_cell, consts):
    """(L,Nd,3) points at (L,B,3) centers -> (L,B,Nd) distances to the
    nearest occupied cell: the table's cell at the clamped voxel, the
    integer squared distance to it, sqrt / scale, plus the out-of-bounds
    extension.  The steps of K1/K3, point for point."""
    pos = pts_rot[:, None, :, :] + centers[:, :, None, :]    # (L,B,Nd,3)
    raw, clamped = voxel_indices(pos, consts)
    cell = nearest_cell[flat_index(clamped, consts)].long()
    diff = clamped - cell_coords[cell]
    d2 = torch.sum(diff * diff, dim=-1)
    dist = exact_sqrt(d2.to(torch.float32)) / consts[3]
    oob, extra = oob_extension(raw, consts)
    return torch.where(oob, dist + extra, dist)


def geometric_bounds_plain(pts_rot, centers, widths, rot_unc, weights,
                           cell_coords, nearest_cell, consts,
                           trim_count=None, *, size: int, norm: int,
                           fused: bool = False, trim_k: int = 0):
    """K1's function in plain torch: per point the table lookup of
    point_distances, then the same reductions as the gather path
    (evaluate.py)."""
    dist = point_distances(pts_rot, centers, cell_coords, nearest_cell,
                           consts)
    dis = weights[None, None, :] * dist
    mask = (weights > 0)[None, None, :]
    if trim_count is not None:
        k, static = trim_count, False
    elif trim_k:
        k, static = trim_k, True
    else:
        k, static = None, False
    return reduce_bounds(dis, widths, rot_unc, norm, fused, mask=mask, k=k,
                         static=static)


def chem_incomp_plain(pts_rot, corners, cell_compat, prop_onehot, data_mask,
                      nearest_cell, consts, *, size: int):
    """K2's function in plain torch: the table's cell at each clamped voxel,
    inc = mask - onehot . cell_compat[cell], summed."""
    pos = pts_rot[:, None, :, :] + corners[:, :, None, :]    # (L,Q,Nd,3)
    _, clamped = voxel_indices(pos, consts)
    cell = nearest_cell[flat_index(clamped, consts)].long()  # (L,Q,Nd)
    h = cell_compat[cell]                                    # (L,Q,Nd,9)
    s = torch.sum(prop_onehot[None, None] * h, dim=-1)
    inc = (data_mask > 0).to(torch.float32)[None, None, :] - s
    return torch.sum(inc, dim=-1)


def _per_pair_lanes(lane_pair: torch.Tensor, n_pairs: int):
    """(pair, its lane indices) for every pair that owns a lane."""
    for w in range(n_pairs):
        sel = torch.nonzero(lane_pair == w)[:, 0]
        if sel.numel():
            yield w, sel


def geometric_bounds_lanes_plain(pts_rot, centers, widths, rot_unc, weights,
                                 cell_coords, nearest_cell, consts,
                                 trim_count, lane_pair, *, size: int,
                                 norm: int):
    """K3's function in plain torch: every lane through
    geometric_bounds_plain (fused) with the tables of its own pair."""
    L, B = widths.shape
    outs = [torch.empty((L, B), dtype=torch.float32, device=pts_rot.device)
            for _ in range(3)]
    for w, sel in _per_pair_lanes(lane_pair, weights.shape[0]):
        got = geometric_bounds_plain(
            pts_rot[sel], centers[sel], widths[sel], rot_unc[sel],
            weights[w], cell_coords[w], nearest_cell[w], consts[w],
            None if trim_count is None else trim_count[w],
            size=size, norm=norm, fused=True)
        for o, g in zip(outs, got):
            o[sel] = g
    return tuple(outs)


def chem_incomp_lanes_plain(pts_rot, corners, cell_compat, prop_onehot,
                            data_mask, nearest_cell, consts, lane_pair, *,
                            size: int):
    """K4's function in plain torch: every lane through chem_incomp_plain
    with the tables of its own pair."""
    out = torch.empty(corners.shape[:2], dtype=torch.float32,
                      device=pts_rot.device)
    for w, sel in _per_pair_lanes(lane_pair, cell_compat.shape[0]):
        out[sel] = chem_incomp_plain(
            pts_rot[sel], corners[sel], cell_compat[w], prop_onehot[w],
            data_mask[w], nearest_cell[w], consts[w], size=size)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no bound kernel for device {t.device}")
    return t.device.type


def in_envelope(nd: int, n_cells: int, size: int) -> bool:
    """The shapes every kernel here takes."""
    return 0 < nd <= MAX_POINTS and 0 < n_cells and 2 <= size <= MAX_SIZE


def _check_envelope(name: str, nd: int, n_cells: int, size: int):
    if not in_envelope(nd, n_cells, size):
        raise ValueError(f"{name} takes 1..{MAX_POINTS} points, >= 1 cell "
                         f"and grid size 2..{MAX_SIZE}; got Nd={nd}, "
                         f"C={n_cells}, size={size}")


def _launch_check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def geometric_bounds_kernel(pts_rot, centers, widths, rot_unc, weights,
                            cell_coords, nearest_cell, consts,
                            trim_count=None, *, size: int, norm: int,
                            fused: bool = False, trim_k: int = 0):
    """K1.  pts_rot (L,Nd,3), centers (L,B,3), widths (L,B), rot_unc
    (L,Nd)|None, weights (Nd,), cell_coords (C,3) i32, nearest_cell (S^3,)
    i32, consts (5,) f32 -> ub, lb (L,B); fused=True -> (ub_plain, ubu,
    lbu).  Trimming: trim_k>0 static, or trim_count (0-d f32 tensor, read
    on the device)."""
    if _route(pts_rot) == "cpu":
        return geometric_bounds_plain(
            pts_rot, centers, widths, rot_unc, weights, cell_coords,
            nearest_cell, consts, trim_count, size=size, norm=norm,
            fused=fused, trim_k=trim_k)
    from goicp_tpu_torch._build import library
    dev = pts_rot.device
    L, nd, _ = pts_rot.shape
    B = centers.shape[1]
    C = cell_coords.shape[0]
    f32 = torch.float32
    _check("pts_rot", pts_rot, (L, nd, 3), f32, dev)
    _check("centers", centers, (L, B, 3), f32, dev)
    _check("widths", widths, (L, B), f32, dev)
    if rot_unc is not None:
        _check("rot_unc", rot_unc, (L, nd), f32, dev)
    _check("weights", weights, (nd,), f32, dev)
    _check("cell_coords", cell_coords, (C, 3), torch.int32, dev)
    _check("nearest_cell", nearest_cell, (size ** 3,), torch.int32, dev)
    _check("consts", consts, (5,), f32, dev)
    if trim_count is not None:
        _check("trim_count", trim_count, (), f32, dev)
    if norm not in (1, 2):
        raise ValueError(f"norm must be 1 or 2, got {norm}")
    _check_envelope("geometric_bounds_kernel", nd, C, size)
    outs = [torch.empty((L, B), dtype=f32, device=dev)
            for _ in range(3 if fused else 2)]
    if L * B == 0:
        return tuple(outs)
    err = library().goicp_geom_bounds(
        _ptr(pts_rot), _ptr(centers), _ptr(widths), _ptr(rot_unc),
        _ptr(weights), _ptr(cell_coords), _ptr(nearest_cell), _ptr(consts),
        _ptr(trim_count), _ptr(outs[0]), _ptr(outs[1]),
        _ptr(outs[2] if fused else None), L, B, nd, C, size, norm,
        int(fused), 0 if trim_count is not None else int(trim_k),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _launch_check(err, "geom_bounds")
    geometric_bounds_kernel.launches += 1
    return tuple(outs)


geometric_bounds_kernel.launches = 0


def chem_incomp_kernel(pts_rot, corners, cell_compat, prop_onehot, data_mask,
                       nearest_cell, consts, *, size: int):
    """K2.  pts_rot (L,Nd,3), corners (L,Q,3), cell_compat (C,9) f32 0/1,
    prop_onehot (Nd,9) f32 masked one-hot, data_mask (Nd,), nearest_cell
    (S^3,) i32 -> per-corner incompatibility counts (L,Q) f32."""
    if _route(pts_rot) == "cpu":
        return chem_incomp_plain(pts_rot, corners, cell_compat, prop_onehot,
                                 data_mask, nearest_cell, consts, size=size)
    from goicp_tpu_torch._build import library
    dev = pts_rot.device
    L, nd, _ = pts_rot.shape
    Q = corners.shape[1]
    C = cell_compat.shape[0]
    f32 = torch.float32
    _check("pts_rot", pts_rot, (L, nd, 3), f32, dev)
    _check("corners", corners, (L, Q, 3), f32, dev)
    _check("cell_compat", cell_compat, (C, 9), f32, dev)
    _check("prop_onehot", prop_onehot, (nd, 9), f32, dev)
    _check("data_mask", data_mask, (nd,), f32, dev)
    _check("nearest_cell", nearest_cell, (size ** 3,), torch.int32, dev)
    _check("consts", consts, (5,), f32, dev)
    _check_envelope("chem_incomp_kernel", nd, C, size)
    out = torch.empty((L, Q), dtype=f32, device=dev)
    if L * Q == 0:
        return out
    err = library().goicp_chem_incomp(
        _ptr(pts_rot), _ptr(corners), _ptr(cell_compat), _ptr(prop_onehot),
        _ptr(data_mask), _ptr(nearest_cell), _ptr(consts), _ptr(out),
        L, Q, nd, C, size,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _launch_check(err, "chem_incomp")
    chem_incomp_kernel.launches += 1
    return out


chem_incomp_kernel.launches = 0


def geometric_bounds_kernel_lanes(pts_rot, centers, widths, rot_unc, weights,
                                  cell_coords, nearest_cell, consts,
                                  trim_count, lane_pair, *, size: int,
                                  norm: int):
    """K3.  pts_rot (L,Nd,3), centers (L,B,3), widths (L,B), rot_unc (L,Nd);
    per-pair tables weights (W,Nd), cell_coords (W,C,3) i32, nearest_cell
    (W,S^3) i32, consts (W,5), trim_count (W,) f32 or None (no trimming);
    lane_pair (L,) i32 in [0, W) -> (ub_plain, ubu, lbu), each (L,B).  Lane
    l equals K1 in fused mode on lane l with the tables of pair
    lane_pair[l]."""
    if _route(pts_rot) == "cpu":
        return geometric_bounds_lanes_plain(
            pts_rot, centers, widths, rot_unc, weights, cell_coords,
            nearest_cell, consts, trim_count, lane_pair, size=size,
            norm=norm)
    from goicp_tpu_torch._build import library
    dev = pts_rot.device
    L, nd, _ = pts_rot.shape
    B = centers.shape[1]
    W, C = cell_coords.shape[:2]
    f32 = torch.float32
    _check("pts_rot", pts_rot, (L, nd, 3), f32, dev)
    _check("centers", centers, (L, B, 3), f32, dev)
    _check("widths", widths, (L, B), f32, dev)
    _check("rot_unc", rot_unc, (L, nd), f32, dev)
    _check("weights", weights, (W, nd), f32, dev)
    _check("cell_coords", cell_coords, (W, C, 3), torch.int32, dev)
    _check("nearest_cell", nearest_cell, (W, size ** 3), torch.int32, dev)
    _check("consts", consts, (W, 5), f32, dev)
    if trim_count is not None:
        _check("trim_count", trim_count, (W,), f32, dev)
    _check("lane_pair", lane_pair, (L,), torch.int32, dev)
    if norm not in (1, 2):
        raise ValueError(f"norm must be 1 or 2, got {norm}")
    _check_envelope("geometric_bounds_kernel_lanes", nd, C, size)
    outs = [torch.empty((L, B), dtype=f32, device=dev) for _ in range(3)]
    if L * B == 0:
        return tuple(outs)
    err = library().goicp_geom_bounds_lanes(
        _ptr(pts_rot), _ptr(centers), _ptr(widths), _ptr(rot_unc),
        _ptr(weights), _ptr(cell_coords), _ptr(nearest_cell), _ptr(consts),
        _ptr(trim_count), _ptr(lane_pair), _ptr(outs[0]), _ptr(outs[1]),
        _ptr(outs[2]), L, B, nd, C, size, norm,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _launch_check(err, "geom_bounds_lanes")
    geometric_bounds_kernel_lanes.launches += 1
    return tuple(outs)


geometric_bounds_kernel_lanes.launches = 0


def chem_incomp_kernel_lanes(pts_rot, corners, cell_compat, prop_onehot,
                             data_mask, nearest_cell, consts, lane_pair, *,
                             size: int):
    """K4.  pts_rot (L,Nd,3), corners (L,Q,3); per-pair tables cell_compat
    (W,C,9), prop_onehot (W,Nd,9), data_mask (W,Nd), nearest_cell (W,S^3)
    i32, consts (W,5); lane_pair (L,) i32 -> counts (L,Q) f32.  Lane l
    equals K2 on lane l with the tables of pair lane_pair[l]."""
    if _route(pts_rot) == "cpu":
        return chem_incomp_lanes_plain(
            pts_rot, corners, cell_compat, prop_onehot, data_mask,
            nearest_cell, consts, lane_pair, size=size)
    from goicp_tpu_torch._build import library
    dev = pts_rot.device
    L, nd, _ = pts_rot.shape
    Q = corners.shape[1]
    W, C = cell_compat.shape[:2]
    f32 = torch.float32
    _check("pts_rot", pts_rot, (L, nd, 3), f32, dev)
    _check("corners", corners, (L, Q, 3), f32, dev)
    _check("cell_compat", cell_compat, (W, C, 9), f32, dev)
    _check("prop_onehot", prop_onehot, (W, nd, 9), f32, dev)
    _check("data_mask", data_mask, (W, nd), f32, dev)
    _check("nearest_cell", nearest_cell, (W, size ** 3), torch.int32, dev)
    _check("consts", consts, (W, 5), f32, dev)
    _check("lane_pair", lane_pair, (L,), torch.int32, dev)
    _check_envelope("chem_incomp_kernel_lanes", nd, C, size)
    out = torch.empty((L, Q), dtype=f32, device=dev)
    if L * Q == 0:
        return out
    err = library().goicp_chem_incomp_lanes(
        _ptr(pts_rot), _ptr(corners), _ptr(cell_compat), _ptr(prop_onehot),
        _ptr(data_mask), _ptr(nearest_cell), _ptr(consts), _ptr(lane_pair),
        _ptr(out), L, Q, nd, C, size,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _launch_check(err, "chem_incomp_lanes")
    chem_incomp_kernel_lanes.launches += 1
    return out


chem_incomp_kernel_lanes.launches = 0

# the four bound kernels, the fixed-order kernels of utils/fp32.py and the
# ICP's (icp/icp.py), whose launch counts every run reads together with
# the inner step's
_KERNELS = (geometric_bounds_kernel, chem_incomp_kernel,
            geometric_bounds_kernel_lanes, chem_incomp_kernel_lanes,
            ordered_sum, rotate, norm3, sincos32, rodrigues_kernel,
            rot_uncertainty_kernel, sq_dist3, det3, cross3, dot_fma, icp_run,
            kabsch3)


def _all_kernels() -> tuple:
    """_KERNELS, the inner step's and run's (search/inner.py), the
    transition's (search/transition.py), the rescoring's
    (bounds/error.py) and the pick's, the refine route's and the initial
    route's (search/pick.py), which import this module or what it
    imports."""
    from goicp_tpu_torch.bounds.error import score_kernel
    from goicp_tpu_torch.search.inner import inner_run, inner_step
    from goicp_tpu_torch.search.pick import (icp_init, icp_refine,
                                             icp_seeds, score_initial,
                                             score_pick)
    from goicp_tpu_torch.search.transition import advance, harvest
    return _KERNELS + (inner_step, inner_run, harvest, advance, score_kernel,
                       icp_seeds, score_pick, score_initial, icp_refine,
                       icp_init)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in _all_kernels()}


def reset_launch_counts():
    """Zero every kernel's launch count, the torch body's iterations on
    the card (search/inner.py::body_on_card) and the torch transition's
    rows on the card (search/transition.py::plain_on_card)."""
    from goicp_tpu_torch.search.inner import body_on_card
    from goicp_tpu_torch.search.transition import plain_on_card
    for k in _all_kernels():
        k.launches = 0
    body_on_card["iterations"] = 0
    plain_on_card["rows"] = 0


def empty_launch(device) -> None:
    """Launch the library's empty kernel on `device`'s current stream: the
    floor under every kernel launch, for the measurements."""
    from goicp_tpu_torch._build import library
    _launch_check(library().goicp_empty_launch(
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)),
        "empty")
