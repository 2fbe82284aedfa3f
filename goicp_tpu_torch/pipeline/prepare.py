"""Per-pair data preparation.

Port of goicp_tpu/pipeline/prepare.py.  Builds everything the search needs
as tensors on one device:

  * grid fields (exact EDT + nearest-occupied-cell), see grid/edt.py
  * per-point weights (ponderation), neighbor counts
  * chem tables indexed by (data point, occupied cell): compat_table,
    fpfh_table, and the rank-9 factor cell_compat the chem kernel reads
    (compat_table == prop_onehot @ cell_compat.T)

Shape-bucket padding parks padded data points at +4e3 and padded model
points at -4e3 with zero weight/mask, so every bound, trim, chem and ICP
path is padding-invariant.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from goicp_tpu_torch import default_device
from goicp_tpu_torch.chem.neighbors import neighbor_counts, neighbor_weights
from goicp_tpu_torch.chem.properties import (codes_to_indices,
                                             compatibility_matrix)
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.grid.edt import (Grid, GridGeometry, build_grid,
                                      grid_geometry, round_ref_np)
from goicp_tpu_torch.io.cfpfh import select_bins
from goicp_tpu_torch.utils.fp32 import norm3, ordered_sum


@dataclasses.dataclass
class PairData:
    """Inputs for one registration pair, as tensors on one device."""
    data: torch.Tensor          # (Nd, 3) f32 source cloud (normalized)
    model: torch.Tensor         # (Nm, 3) f32 target cloud (normalized)
    weights: torch.Tensor       # (Nd,) f32
    data_props: torch.Tensor    # (Nd,) i32 dense property indices
    model_props: torch.Tensor   # (Nm,) i32
    data_nbrs: torch.Tensor     # (Nd,) i32 neighbor counts (radius arg 0.050)
    model_nbrs: torch.Tensor    # (Nm,) i32
    data_fpfh: torch.Tensor     # (Nd, B) f32 selected bins (B=1 dummy if off)
    model_fpfh: torch.Tensor    # (Nm, B) f32
    grid: Grid
    compat_table: torch.Tensor  # (Nd, C) bool
    fpfh_table: torch.Tensor    # (Nd, C) f32
    cell_compat: torch.Tensor   # (C, 9) f32 0/1 rank factor
    prop_onehot: torch.Tensor   # (Nd, 9) f32 one-hot of data_props x mask
    norm_data: torch.Tensor     # (Nd,) f32 point norms (rot uncertainty)
    comp_voxel: torch.Tensor    # (Nd, S^3) bool fused chem table, or (0,0)
    fpfh_voxel: torch.Tensor    # (Nd, S^3) f32 fused chem table, or (0,0)
    data_mask: torch.Tensor     # (Nd,) f32 1 for real points, 0 for padding
    counts: torch.Tensor        # (3,) f32 [n_data, inlier_num, n_model]
    inlier_num: int             # inliers among REAL points
    n_data: int                 # REAL data point count
    n_model: int                # REAL model point count
    fused_chem: bool            # per-voxel chem tables materialized
    dynamic_counts: bool = False  # counts come from the `counts` tensor

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def n_data_padded(self) -> int:
        return self.data.shape[-2]

    @property
    def padded(self) -> bool:
        return self.dynamic_counts or self.n_data_padded != self.n_data

    # count VALUES for thresholds/normalizations: 0-d tensors read from
    # `counts` in dynamic_counts mode (no host sync), constants otherwise
    def nd_f(self) -> torch.Tensor:
        return self.counts[0] if self.dynamic_counts \
            else torch.tensor(float(self.n_data), device=self.device)

    def inlier_f(self) -> torch.Tensor:
        return self.counts[1] if self.dynamic_counts \
            else torch.tensor(float(self.inlier_num), device=self.device)

    def map_tensors(self, fn) -> "PairData":
        """The same pair with fn applied to every tensor leaf (the grid's
        included); the host-side fields are kept."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                kw[f.name] = fn(v)
            elif isinstance(v, Grid):
                kw[f.name] = v.map_tensors(fn)
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "PairData":
        return self.map_tensors(lambda t: t.to(device))


def make_count_dynamic(pair: PairData) -> PairData:
    """Re-key a bucketed pair so its REAL point counts travel in the
    `counts` tensor: every selection switches from a static top-k to an
    exact rank mask over sorted values, reading the inlier count from
    counts[1]."""
    return dataclasses.replace(
        pair, dynamic_counts=True,
        inlier_num=pair.n_data_padded, n_data=pair.n_data_padded,
        n_model=pair.model.shape[-2])


def _chem_tables(grid: Grid, data_props: torch.Tensor,
                 data_fpfh: torch.Tensor, model_fpfh: torch.Tensor,
                 compat: torch.Tensor):
    """compat_table (Nd,C) bool, fpfh_table (Nd,C) f32, cell_compat (C,9)."""
    color = grid.cell_color.long()               # (C,)
    mask = grid.cell_mask                        # (C,)
    props = data_props.long()
    uniform = color >= 0
    color0 = torch.clamp(color, min=0)
    # uniform cell: compatibility map row lookup
    comp_uniform = compat[props][:, color0]                       # (Nd, C)
    # mixed cell: any point in cell with equal property (bitmask test)
    comp_mixed = ((mask[None, :] >> data_props[:, None]) & 1) == 1
    compat_table = torch.where(uniform[None, :], comp_uniform, comp_mixed)

    # exact rank-9 factorization of the same table
    ks = torch.arange(9, dtype=mask.dtype, device=mask.device)
    hu = compat[:, color0].T                                      # (C, 9)
    hm = ((mask[:, None] >> ks[None, :]) & 1) == 1                # (C, 9)
    cell_compat = torch.where(uniform[:, None], hu, hm).to(
        torch.float32).contiguous()

    # fpfh_table: min over cell points of L1 descriptor distance
    cell_points = grid.cell_points.long()
    fpfh_table = torch.full((props.shape[0], color.shape[0]), float("inf"),
                            dtype=torch.float32, device=props.device)
    for k in range(cell_points.shape[1]):
        pt = cell_points[:, k]                         # (C,)
        valid = pt >= 0
        fm = model_fpfh[torch.clamp(pt, min=0)]        # (C, B)
        d = ordered_sum(torch.abs(data_fpfh[:, None, :] - fm[None, :, :]))
        d = torch.where(valid[None, :], d, torch.full_like(d, float("inf")))
        fpfh_table = torch.minimum(fpfh_table, d)
    # cells with no points (padding) keep +inf; real lookups never hit them
    return compat_table, fpfh_table, cell_compat


def _ceil_to(x, m):
    return int(-(-x // m) * m)


def bucket_dims(target: np.ndarray, nd: int, nm: int,
                cfg: GoICPConfig) -> dict:
    """Static shape-bucket dimensions a pair needs (host-side): occupied-
    cell count / max points-per-cell of the target's grid and the rounded-
    up cloud sizes.  For cross-pair batching, take the elementwise max of
    every pair's dims and pass them to prepare_pair."""
    tgt = np.asarray(target, np.float32)
    geom = grid_geometry(tgt, cfg.distTransSize, cfg.distTransExpandFactor)
    lo = np.array([geom.x_min, geom.y_min, geom.z_min])
    vidx = np.clip(round_ref_np((tgt - lo) * geom.scale), 0, geom.size - 1)
    flat = (vidx[:, 2].astype(np.int64) * geom.size
            + vidx[:, 1]) * geom.size + vidx[:, 0]
    _, counts = np.unique(flat, return_counts=True)
    return dict(pad_cells=_ceil_to(len(counts), 32),
                pad_points=_ceil_to(int(counts.max()), 8),
                pad_data_to=_ceil_to(nd, 32),
                pad_model_to=_ceil_to(nm, 32))


def plan_buckets(dims_list: list[dict], max_buckets: int = 3,
                 min_per_bucket: int = 4, lane: int = 128) -> list:
    """Partition a pair pool into <= max_buckets shape buckets: pairs sorted
    by bound-kernel volume and split into count-equal contiguous groups;
    each bucket's dims are the elementwise max over its pairs, and groups
    whose dims collapse to the same values are merged.
    Returns [(bucket_dims, indices)]."""
    n = len(dims_list)

    def vol(d):
        return _ceil_to(d["pad_data_to"], lane) * d["pad_cells"]

    order = sorted(range(n), key=lambda i: (vol(dims_list[i]),
                                            dims_list[i]["pad_model_to"]))
    k = max(1, min(max_buckets, n // max(min_per_bucket, 1)))
    out: list = []
    for g in range(k):
        idxs = order[g * n // k:(g + 1) * n // k]
        if not idxs:
            continue
        bd = {key: max(dims_list[i][key] for i in idxs)
              for key in dims_list[0]}
        if out and out[-1][0] == bd:
            out[-1][1].extend(idxs)
        else:
            out.append((bd, list(idxs)))
    return out


def prepare_pair(source: np.ndarray, target: np.ndarray,
                 source_props: np.ndarray, target_props: np.ndarray,
                 cfg: GoICPConfig,
                 source_fpfh: np.ndarray | None = None,
                 target_fpfh: np.ndarray | None = None,
                 nd_downsampled: int = 0,
                 pad_cells: int | None = None,
                 pad_points: int | None = None,
                 pad_data_to: int | None = None,
                 pad_model_to: int | None = None,
                 bucket: bool = False,
                 device: torch.device | str | None = None) -> PairData:
    """source/target: normalized clouds (f64 host); props: raw codes or
    dense indices (values < 9 treated as dense).  pad_* / bucket: pad to a
    static shape bucket (see bucket_dims).  device: where the pair's
    tensors live; None means goicp_tpu_torch.default_device()."""
    if device is None:
        device = default_device()
    src = np.asarray(source, dtype=np.float32)
    tgt = np.asarray(target, dtype=np.float32)
    sp = np.asarray(source_props)
    tp = np.asarray(target_props)
    if sp.size and sp.max(initial=0) >= 9:
        sp = codes_to_indices(sp)
    if tp.size and tp.max(initial=0) >= 9:
        tp = codes_to_indices(tp)
    sp = sp.astype(np.int32)
    tp = tp.astype(np.int32)

    # prefix downsampling (jly_main.cpp:114-117) — applies to the data cloud
    # AFTER the DT is built on the model; weights use the downsampled set
    if nd_downsampled and nd_downsampled > 0:
        src = src[:nd_downsampled]
        sp = sp[:nd_downsampled]
        if source_fpfh is not None:
            source_fpfh = source_fpfh[:nd_downsampled]
    nd, nm = len(src), len(tgt)

    if bucket:
        dims = bucket_dims(tgt, nd, nm, cfg)
        pad_cells = max(pad_cells or 0, dims["pad_cells"])
        pad_points = max(pad_points or 0, dims["pad_points"])
        pad_data_to = max(pad_data_to or 0, dims["pad_data_to"])
        pad_model_to = max(pad_model_to or 0, dims["pad_model_to"])

    # grid and host-side features are computed from REAL points only
    grid = build_grid(tgt, tp, cfg.distTransSize, cfg.distTransExpandFactor,
                      pad_cells=pad_cells, pad_points=pad_points,
                      device=device)

    weights = np.ones(nd, dtype=np.float32)
    if cfg.ponderation == 1:
        weights = neighbor_weights(src)

    need_nbrs = cfg.regularizationNeighbors > 0
    data_nbrs = neighbor_counts(src, 0.050) if need_nbrs \
        else np.zeros(nd, np.int32)
    model_nbrs = neighbor_counts(tgt, 0.050) if need_nbrs \
        else np.zeros(nm, np.int32)

    use_fpfh = cfg.cfpfh != 0 and source_fpfh is not None
    if use_fpfh:
        sf = select_bins(np.asarray(source_fpfh, np.float32), cfg.cfpfh)
        tf = select_bins(np.asarray(target_fpfh, np.float32), cfg.cfpfh)
    else:
        sf = np.zeros((nd, 1), np.float32)
        tf = np.zeros((nm, 1), np.float32)

    # ---- shape-bucket padding ----
    ndp = max(pad_data_to or nd, nd)
    nmp = max(pad_model_to or nm, nm)
    data_mask = np.zeros(ndp, np.float32)
    data_mask[:nd] = 1.0
    if ndp > nd:
        # data padding parked far +; model padding far -, so padded points
        # are never nearest neighbors of anything real
        src = np.vstack([src, np.full((ndp - nd, 3), 4.0e3, np.float32)])
        sp = np.concatenate([sp, np.zeros(ndp - nd, np.int32)])
        weights = np.concatenate([weights, np.zeros(ndp - nd, np.float32)])
        data_nbrs = np.concatenate([data_nbrs, np.zeros(ndp - nd, np.int32)])
        sf = np.vstack([sf, np.zeros((ndp - nd, sf.shape[1]), np.float32)])
    if nmp > nm:
        tgt = np.vstack([tgt, np.full((nmp - nm, 3), -4.0e3, np.float32)])
        tp = np.concatenate([tp, np.zeros(nmp - nm, np.int32)])
        model_nbrs = np.concatenate([model_nbrs,
                                     np.zeros(nmp - nm, np.int32)])
        tf = np.vstack([tf, np.zeros((nmp - nm, tf.shape[1]), np.float32)])

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    src_t, sp_t, mask_t = dev(src), dev(sp), dev(data_mask)
    compat = dev(compatibility_matrix())
    compat_table, fpfh_table, cell_compat = _chem_tables(
        grid, sp_t, dev(sf), dev(tf), compat)
    if ndp > nd:
        # padded data rows: always-compatible, zero descriptor distance, so
        # chem counts/sums are padding-invariant
        mask_col = mask_t[:, None] > 0
        compat_table = torch.where(mask_col, compat_table,
                                   torch.ones_like(compat_table))
        fpfh_table = torch.where(mask_col, fpfh_table,
                                 torch.zeros_like(fpfh_table))
    # masked one-hot: padded points contribute inc = mask - sum == 0
    ks = torch.arange(9, dtype=sp_t.dtype, device=sp_t.device)
    prop_onehot = (sp_t[:, None] == ks[None, :]).to(torch.float32) \
        * mask_t[:, None]

    # fused per-(point, voxel) chem tables: one gather instead of
    # voxel -> nearest-cell -> (point, cell) table, on small grids only
    chem_active = (cfg.regularization > 0
                   or (cfg.regularizationFPFH > 0 and cfg.cfpfh != 0))
    s3 = cfg.distTransSize ** 3
    fused_chem = bool(chem_active and ndp * s3 <= 64_000_000)
    nearest = grid.nearest_cell.long()
    if fused_chem:
        comp_voxel = compat_table[:, nearest]
        fpfh_voxel = fpfh_table[:, nearest] \
            if (cfg.regularizationFPFH > 0 and cfg.cfpfh != 0) \
            else torch.zeros((0, 0), dtype=torch.float32, device=device)
    else:
        comp_voxel = torch.zeros((0, 0), dtype=torch.bool, device=device)
        fpfh_voxel = torch.zeros((0, 0), dtype=torch.float32, device=device)

    # a tiny cloud with a large trimFraction must keep >= 1 inlier
    inlier = max(1, int(nd * (1 - cfg.trimFraction))) if cfg.doTrim else nd
    norm_data = norm3(src_t) * mask_t
    return PairData(
        data=src_t, model=dev(tgt), weights=dev(weights),
        data_props=sp_t, model_props=dev(tp),
        data_nbrs=dev(data_nbrs), model_nbrs=dev(model_nbrs),
        data_fpfh=dev(sf), model_fpfh=dev(tf),
        grid=grid, compat_table=compat_table, fpfh_table=fpfh_table,
        cell_compat=cell_compat, prop_onehot=prop_onehot,
        norm_data=norm_data,
        comp_voxel=comp_voxel, fpfh_voxel=fpfh_voxel,
        data_mask=mask_t,
        counts=torch.tensor([nd, inlier, nm], dtype=torch.float32,
                            device=device),
        inlier_num=inlier, n_data=nd, n_model=nm, fused_chem=fused_chem,
    )


def pair_from_jax(pair, device: torch.device | str | None = None
                  ) -> PairData:
    """A JAX `goicp_tpu` PairData -> the port's PairData, leaf by leaf
    (each converted with np.asarray), so both packages search the very
    same prepared pair.  Duck-typed: nothing of JAX is imported here.
    device None means goicp_tpu_torch.default_device()."""
    if device is None:
        device = default_device()
    def t(x):
        return torch.as_tensor(np.array(np.asarray(x)), device=device)

    g = pair.grid
    grid = Grid(dist=t(g.dist), nearest_cell=t(g.nearest_cell),
                cell_color=t(g.cell_color), cell_mask=t(g.cell_mask),
                cell_points=t(g.cell_points), cell_count=t(g.cell_count),
                cell_coords=t(g.cell_coords), consts=t(g.consts),
                n_cells=int(g.n_cells),
                geom=GridGeometry(size=g.geom.size, scale=g.geom.scale,
                                  x_min=g.geom.x_min, y_min=g.geom.y_min,
                                  z_min=g.geom.z_min))
    leaves = {f.name: t(getattr(pair, f.name))
              for f in dataclasses.fields(PairData)
              if f.type in ("torch.Tensor",)}
    return PairData(grid=grid, inlier_num=int(pair.inlier_num),
                    n_data=int(pair.n_data), n_model=int(pair.n_model),
                    fused_chem=bool(pair.fused_chem),
                    dynamic_counts=bool(pair.dynamic_counts), **leaves)
