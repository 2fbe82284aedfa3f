"""Exact 3D Euclidean distance transform + nearest-occupied-cell fields.

Port of goicp_tpu/grid/edt.py.  The EDT is an exact argmin, over the
occupied voxel centers, of the squared distance from every voxel center of
the SIZE^3 grid.  Voxel and cell coordinates are small integers, so the
squared distances are exact integers in float32 (the JAX package's f32
matmul form, bit for bit), with the same first-minimum tie-break (the
smallest cell index wins).

Voxelization keeps the reference's ROUND(x) = int(x + 0.5), C truncation
toward zero (jly_3ddt.cpp:30).  All distances are stored divided by
`scale` (world units), matching jly_3ddt.cpp:1003.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_EDT_CHUNK_ELEMS = 1 << 22   # voxel x cell pairs per argmin chunk
_NEVER = 1.0e9               # |c|^2 of a padding cell: it never wins


def round_ref(x: torch.Tensor) -> torch.Tensor:
    """ROUND(x) = int(x + 0.5): trunc toward zero, as the C++ cast does.
    (Differs from floor(x+0.5) for x in [-1.5, -0.5).)"""
    return torch.trunc(x + 0.5).to(torch.int32)


def exact_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt.  torch.sqrt of a float32 CPU tensor is
    not correctly rounded in every build (torch 2.13.0+cpu: one ulp off for
    ~17 % of the integers below 3*1024^2), while XLA's and CUDA's are.  The
    square root of a float32 taken in float64 and rounded once to float32
    is the correctly rounded one, on any device."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def round_ref_np(x):
    return np.trunc(np.asarray(x) + 0.5).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Static grid geometry (host floats; mirrored by Grid.consts)."""
    size: int
    scale: float
    x_min: float
    y_min: float
    z_min: float


@dataclasses.dataclass
class Grid:
    """Distance-transform fields for one model cloud.

    dist:          (S^3,) f32  distance (world units) to nearest occupied cell
    nearest_cell:  (S^3,) i32  index into the occupied-cell arrays
    cell_color:    (C,)   i32  uniform property index 0..8, or -1 if mixed
    cell_mask:     (C,)   i32  bitmask of property indices present in cell
    cell_points:   (C,K)  i32  model point indices in cell, -1 padded
    cell_count:    (C,)   i32  number of valid entries in cell_points
    cell_coords:   (C,3)  i32  voxel coords of the cell (x,y,z); padding
                               cells lie outside [0, S) and never win
    consts:        (5,)   f32  [x_min, y_min, z_min, scale, size]
    n_cells:       int         number of real (non-padding) cells
    geom:          GridGeometry
    """
    dist: torch.Tensor
    nearest_cell: torch.Tensor
    cell_color: torch.Tensor
    cell_mask: torch.Tensor
    cell_points: torch.Tensor
    cell_count: torch.Tensor
    cell_coords: torch.Tensor
    consts: torch.Tensor
    n_cells: int
    geom: GridGeometry

    def map_tensors(self, fn) -> "Grid":
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def to(self, device) -> "Grid":
        return self.map_tensors(lambda t: t.to(device))


def grid_geometry(model: np.ndarray, size: int, expand_factor: float
                  ) -> GridGeometry:
    """Reference bbox semantics (jly_3ddt.cpp:899-930)."""
    model = np.asarray(model, dtype=np.float64)
    mn = model.min(axis=0)
    mx = model.max(axis=0)
    center = (mn + mx) / 2.0
    half = expand_factor * (mx - center)
    extent = float((2.0 * half).max())
    lo = center - extent / 2.0
    scale = size / extent
    return GridGeometry(size=size, scale=float(scale),
                        x_min=float(lo[0]), y_min=float(lo[1]),
                        z_min=float(lo[2]))


def _occupied_cells(model: np.ndarray, props_idx: np.ndarray,
                    geom: GridGeometry, pad_cells: int | None = None,
                    pad_points: int | None = None):
    """Voxelize model points; build occupied-cell tables (host, numpy)."""
    lo = np.array([geom.x_min, geom.y_min, geom.z_min])
    idx = round_ref_np((model - lo) * geom.scale)
    idx = np.clip(idx, 0, geom.size - 1)

    flat = (idx[:, 2].astype(np.int64) * geom.size + idx[:, 1]) * geom.size \
        + idx[:, 0]
    uniq, inverse = np.unique(flat, return_inverse=True)
    n_cells = len(uniq)
    counts = np.bincount(inverse, minlength=n_cells)
    k_max = int(counts.max())

    n_pad = pad_cells if pad_cells is not None else n_cells
    k_pad = pad_points if pad_points is not None else k_max
    assert n_pad >= n_cells and k_pad >= k_max

    cell_points = np.full((n_pad, k_pad), -1, dtype=np.int32)
    fill = np.zeros(n_cells, dtype=np.int64)
    for p, c in enumerate(inverse):
        cell_points[c, fill[c]] = p
        fill[c] += 1

    cell_coords = np.zeros((n_pad, 3), dtype=np.int32)
    cell_coords[:n_cells, 0] = uniq % geom.size
    cell_coords[:n_cells, 1] = (uniq // geom.size) % geom.size
    cell_coords[:n_cells, 2] = uniq // (geom.size * geom.size)
    # padding cells parked far away so the EDT argmin never picks them
    cell_coords[n_cells:] = 2 ** 20

    cell_color = np.full(n_pad, -1, dtype=np.int32)
    cell_mask = np.zeros(n_pad, dtype=np.int32)
    cell_count = np.zeros(n_pad, dtype=np.int32)
    cell_count[:n_cells] = counts
    props_idx = np.asarray(props_idx, dtype=np.int32)
    for c in range(n_cells):
        pts = cell_points[c, :counts[c]]
        pr = props_idx[pts]
        cell_mask[c] = int(np.bitwise_or.reduce(1 << pr.astype(np.int64)))
        cell_color[c] = int(pr[0]) if (pr == pr[0]).all() else -1

    return dict(n_cells=n_cells, cell_points=cell_points,
                cell_coords=cell_coords, cell_color=cell_color,
                cell_mask=cell_mask, cell_count=cell_count,
                flat_uniq=uniq)


def nearest_occupied(voxels: torch.Tensor, cell_coords: torch.Tensor,
                     size: int):
    """Exact nearest occupied cell of integer voxels (N, 3): returns the
    squared voxel distance (N,) i64 and the cell index (N,) i64.  Cells
    outside [0, size) are padding and never win; ties go to the smallest
    cell index (first minimum)."""
    # |v - c|^2 = |v|^2 + |c|^2 - 2 v.c in float32, one small matmul per
    # chunk: every term and partial sum is an integer below 2^24 (voxels and
    # real cells lie in [0, size), size <= 1024), so the result is exact
    cells = cell_coords.to(torch.int32)
    valid = ((cells >= 0) & (cells < size)).all(dim=1)
    cf = torch.where(valid[:, None], cells, 0).to(torch.float32)
    cc = torch.where(valid, torch.sum(cf * cf, dim=1), _NEVER)
    vf = voxels.to(torch.float32)
    vv = torch.sum(vf * vf, dim=1)
    chunk = max(1, _EDT_CHUNK_ELEMS // max(cells.shape[0], 1))
    best_d, best_i = [], []
    for start in range(0, vf.shape[0], chunk):
        d2 = torch.addmm(vv[start:start + chunk, None] + cc[None, :],
                         vf[start:start + chunk], cf.T, alpha=-2.0)
        i = torch.argmin(d2, dim=1)                 # first minimum wins
        best_i.append(i)
        best_d.append(torch.gather(d2, 1, i[:, None])[:, 0].to(torch.int64))
    return torch.cat(best_d), torch.cat(best_i)


def _edt_fields(cell_coords: torch.Tensor, size: int):
    """Exact EDT over the full grid vs the occupied voxel centers.

    cell_coords: (C, 3) i32; cells outside [0, size) are padding and never
    win.  Returns dist_voxels (S^3,) f32 (voxel units), nearest (S^3,) i32.
    """
    flat = torch.arange(size ** 3, dtype=torch.int64,
                        device=cell_coords.device)
    vox = torch.stack([flat % size, (flat // size) % size,
                       flat // (size * size)], dim=1)
    d2, nearest = nearest_occupied(vox, cell_coords, size)
    return exact_sqrt(d2.to(torch.float32)), nearest.to(torch.int32)


def build_grid(model: np.ndarray, props_idx: np.ndarray, size: int,
               expand_factor: float, pad_cells: int | None = None,
               pad_points: int | None = None,
               device: torch.device | str | None = None) -> Grid:
    """Build all distance-transform fields for a model cloud on `device`
    (None: goicp_tpu_torch.default_device())."""
    if device is None:
        from goicp_tpu_torch import default_device
        device = default_device()
    geom = grid_geometry(model, size, expand_factor)
    cells = _occupied_cells(model, props_idx, geom, pad_cells, pad_points)
    cell_coords = torch.as_tensor(cells["cell_coords"], device=device)
    dist_vox, nearest = _edt_fields(cell_coords, size)
    dist = dist_vox / torch.tensor(geom.scale, dtype=torch.float32,
                                   device=device)
    consts = torch.tensor([geom.x_min, geom.y_min, geom.z_min, geom.scale,
                           float(size)], dtype=torch.float32, device=device)
    return Grid(
        dist=dist,
        nearest_cell=nearest,
        cell_color=torch.as_tensor(cells["cell_color"], device=device),
        cell_mask=torch.as_tensor(cells["cell_mask"], device=device),
        cell_points=torch.as_tensor(cells["cell_points"], device=device),
        cell_count=torch.as_tensor(cells["cell_count"], device=device),
        cell_coords=cell_coords,
        consts=consts,
        n_cells=cells["n_cells"],
        geom=geom,
    )
