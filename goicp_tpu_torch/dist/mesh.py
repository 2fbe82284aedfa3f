"""Pair stacking for the cross-pair engines.

Port of goicp_tpu/dist/mesh.py::stack_pairs.  The device meshes and the
sharded placement of that module belong to the multi-GPU port.
"""

from __future__ import annotations

import torch

from goicp_tpu_torch.pipeline.prepare import PairData


def stack_pairs(pairs: list[PairData]) -> PairData:
    """Stack equal-shaped PairData along a new leading pair axis.

    All pairs must share Nd/Nm and grid padding (use prepare_pair's
    pad_cells/pad_points).  Host-side metadata (n_cells, GridGeometry)
    legitimately differs per pair — per-pair geometry travels in the
    `consts` tensor — so the result keeps the first pair's."""
    assert len({p.n_data for p in pairs}) == 1
    assert len({p.n_model for p in pairs}) == 1
    assert len({p.inlier_num for p in pairs}) == 1
    flat = [_leaves(p) for p in pairs]
    stacked = iter([torch.stack(ts) for ts in zip(*flat)])
    return pairs[0].map_tensors(lambda _: next(stacked))


def _leaves(pair: PairData) -> list:
    out = []
    pair.map_tensors(lambda t: out.append(t) or t)
    return out
