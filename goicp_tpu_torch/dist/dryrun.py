"""Run every multi-device engine once over an n-rank mesh, on tiny shapes.

Port of __graft_entry__.py::dryrun_multichip.  Every rank of an n-rank
process group (dist/mesh.init_distributed; dist/spawn.py starts one) calls
dryrun_multichip(n), which runs:

  1. register_device_batch over `data` (pair-level data parallelism, the
     sweep's execution shape);
  2. register_device with the rotation lanes split over the `search` axis
     of the same data x search mesh (the pair replicated over `data`);
  3. register_device_sharded: per-rank rotation frontiers with the
     rebalance and incumbent collectives, over all n ranks;
  4. the fused stream with the window's rows split over `data`;
  5. the straggler handoff: a mid-flight fused row searched on under
     rotation-lane sharding over `search`.

It checks that each engine runs and returns finite errors, not that the
searches converge (random tiny clouds may need many steps to prove
optimality): 10 outer steps (the JAX package's dryrun takes 40) already
run every collective of every engine, a rebalance included.
"""

from __future__ import annotations

import numpy as np

from goicp_tpu_torch.config import GoICPConfig


def _tiny_cfg() -> GoICPConfig:
    return GoICPConfig(MSEThresh=0.001, regularization=0.0005, ponderation=0,
                       distTransSize=10, rot_batch=1, trans_capacity=32,
                       trans_pop=4, inner_max_iters=8, max_outer_steps=10,
                       device_rot_capacity=256, icp_max_iter=50)


def _tiny_pair(cfg: GoICPConfig, device, seed: int = 0, n: int = 24):
    from goicp_tpu_torch.pipeline.prepare import prepare_pair
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.6, 0.6, size=(n, 3))
    data = rng.uniform(-0.6, 0.6, size=(n, 3))
    props = rng.integers(0, 9, size=n).astype(np.int32)
    return prepare_pair(data, model, props, props, cfg, pad_cells=n,
                        pad_points=8, device=device)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Each engine once over a mesh of the n_devices ranks of the current
    process group (n_data 2 when n is even and > 1, n_search the rest).
    device None: the current card.  Returns the errors it checked."""
    from goicp_tpu_torch.dist.mesh import make_mesh, stack_pairs
    from goicp_tpu_torch.search import fused_stream as fs
    from goicp_tpu_torch.search.device_engine import (register_device,
                                                      register_device_batch)
    from goicp_tpu_torch.search.sharded_engine import register_device_sharded

    cfg = _tiny_cfg()
    n_data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_search = n_devices // n_data
    mesh = make_mesh(n_data, n_search, device=device)
    lane_mesh = make_mesh(1, n_devices, device=device)
    pairs = [_tiny_pair(cfg, mesh.device, seed=s)
             for s in range(max(2 * n_data, 2))]

    # 1. pair-level data parallelism
    batch = register_device_batch(pairs, cfg, mesh=mesh).error
    _check(batch.shape == (len(pairs),) and np.isfinite(batch).all(),
           "the batch over data")
    # 2. lane sharding over the combined mesh's search axis
    lane = float(register_device(pairs[0], cfg, mesh=mesh).error)
    _check(np.isfinite(lane), "register_device over search")
    # 3. per-rank frontiers, rebalanced every 2 steps
    sharded = float(register_device_sharded(pairs[0], cfg, lane_mesh,
                                            rebalance_every=2).error)
    _check(np.isfinite(sharded), "register_device_sharded")
    # 4. the fused stream over data (width: the data axis, at least 2)
    stream = fs.register_fused_stream(
        pairs[:max(n_data, 2)] * 2, cfg, width=max(n_data, 2),
        chunk_steps=16, mesh=mesh if n_data > 1 else None).error
    _check(np.isfinite(stream).all(), "the fused stream over data")
    # 5. the straggler handoff over search, from a mid-flight fused row
    handoff = float("nan")
    if n_search > 1:
        pb = stack_pairs([pairs[0]])
        st = fs.fused_run_chunk(pb, cfg, fs._init_batch(pb, cfg), 4)
        handoff = float(fs.straggler_to_lane_sharded(
            pairs[0], cfg, fs._row(st, 0), mesh).error)
        _check(np.isfinite(handoff), "the straggler handoff")
    return dict(batch=batch, lane=lane, sharded=sharded, stream=stream,
                handoff=handoff, n_data=n_data, n_search=n_search)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what} gave a non-finite "
                           f"error")
