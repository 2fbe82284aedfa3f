"""The ranks' side of the port's multi-process tests (test_torch_dist.py,
test_torch_sharded_engine.py, test_torch_straggler.py).

Each *_ranks function runs on every rank of a gloo process group started by
goicp_tpu_torch.dist.spawn.run_ranks (CPU, one process per rank) and
returns a dict of arrays; the test in the pytest process holds them to the
JAX package and to the port's unsharded engines.  This module imports only
numpy, torch and the port, so the ranks start without JAX; the input
recipes live here so that both sides build the same clouds from a seed.
"""

import contextlib
import os
import tempfile

import numpy as np
import torch

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.geom.rotation import rodrigues_np
from goicp_tpu_torch.pipeline.prepare import (bucket_dims, make_count_dynamic,
                                              prepare_pair)

# ---------------------------------------------------------------------------
# the recipes (numpy clouds from a seed; the same on both sides)
# ---------------------------------------------------------------------------

INNER_LAYOUTS = [(1, 2), (2, 2), (2, 1)]
INNER_CFG = dict(MSEThresh=0.001, regularization=0.0005, ponderation=0,
                 distTransSize=10, rot_batch=1, trans_capacity=32,
                 trans_pop=4, inner_max_iters=12)


def inner_clouds(seed: int, n: int = 24):
    """tests/test_dist.py::_pair's clouds: (data, model, props)."""
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.6, 0.6, size=(n, 3))
    data = rng.uniform(-0.6, 0.6, size=(n, 3))
    props = rng.integers(0, 9, size=n).astype(np.int32)
    return data, model, props


def inner_inputs(n_data: int, L: int = 8, n: int = 24):
    """The pre-rotated points, widths, active lanes and incumbents of
    tests/test_dist.py::test_sharded_inner_matches_unsharded."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.6, 0.6, (n_data, L, n, 3)).astype(np.float32)
    widths = np.full((n_data, L), np.pi / 2, np.float32)
    active = np.ones((n_data, L), bool)
    opt = np.full((n_data,), 1e6, np.float32)
    return pts, widths, active, opt


# lane sharding (register_device(mesh=)): tests/test_sharded_engine.py's
# configuration at MSEThresh 0.01, on a noisy pair that searches for 159
# outer steps (the test's own rigid pair converges at its first ICP)
LANE_CFG = dict(MSEThresh=0.01, regularization=0.0005, ponderation=1,
                distTransSize=10, rot_batch=2, trans_capacity=64,
                trans_pop=4, inner_max_iters=200, device_rot_capacity=512,
                max_outer_steps=3000)
SHARDED_CFG = dict(MSEThresh=0.001, regularization=0.0, ponderation=0,
                   distTransSize=20, rot_batch=2, trans_capacity=64,
                   trans_pop=4, inner_max_iters=50, device_rot_capacity=512,
                   max_outer_steps=800)
# tests/test_sharded_rebalance.py's three cases: name -> (cfg overrides,
# pair seed, noise)
SHARDED_CASES = {"optimum": ({}, 11, 0.02),
                 "skew": (dict(rot_batch=1), 23, 0.03),
                 "cadences": ({}, 7, 0.02)}


def sharded_case(name: str, device):
    """(cfg, pair) of a SHARDED_CASES case, in the port."""
    over, seed, noise = SHARDED_CASES[name]
    cfg = GoICPConfig(**dict(SHARDED_CFG, **over))
    return cfg, prepare_pair(*noisy_clouds(seed, noise), cfg, **PAD,
                             device=device)


def noisy_clouds(seed: int, noise: float, n: int = 40, m: int = 44):
    """tests/test_sharded_rebalance.py::_pair's clouds: (data, model,
    data props, model props)."""
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.7, 0.7, size=(m, 3))
    R = rodrigues_np(rng.uniform(-2.0, 2.0, 3))
    tv = rng.uniform(-0.1, 0.1, 3)
    data = (model[:n] - tv) @ R + rng.normal(0.0, noise, (n, 3))
    return (data, model, rng.integers(0, 9, n).astype(np.int32),
            rng.integers(0, 9, m).astype(np.int32))


PAD = dict(pad_cells=64, pad_points=8)

# the streams and batches: tests/test_fused_stream.py's _small_cfg and
# three bucketed, count-dynamic pairs
STREAM_CFG = dict(MSEThresh=0.01, regularization=0.0005, ponderation=1,
                  rot_batch=1, trans_capacity=16, trans_pop=2,
                  inner_max_iters=60, device_rot_capacity=256,
                  max_outer_steps=300, icp_seeds=2, icp_max_iter=60)


def stream_clouds(n: int = 3, seed: int = 11):
    """tests/test_fused_stream.py::_pairs' clouds."""
    rng = np.random.default_rng(seed)
    raw = []
    for _ in range(n):
        nm = int(rng.integers(40, 61))
        nd = int(rng.integers(35, nm + 1))
        model = rng.uniform(-0.7, 0.7, size=(nm, 3))
        R = rodrigues_np(rng.uniform(-2, 2, 3))
        sel = rng.permutation(nm)[:nd]
        data = (model[sel] - rng.uniform(-0.1, 0.1, 3)) @ R
        mp = rng.integers(0, 9, nm).astype(np.int32)
        raw.append((data, model, mp[sel].copy(), mp))
    return raw


# the pipelines: tests/test_torch_pair.py's configuration and pairs
PIPE_CFG = dict(distTransSize=16, rot_batch=2, trans_capacity=32,
                trans_pop=4, inner_max_iters=60, icp_max_iter=50,
                device_rot_capacity=256)


def pipe_pair(seed: int, nm: int, nd: int):
    """tests/test_torch_pair.py::_pair: world-frame clouds, data a rigidly
    moved subset of the model, as bench/bo1_files.write_bo1_root takes
    them."""
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.7, 0.7, (nm, 3)) * 12.0 + [30.0, -5.0, 60.0]
    R = rodrigues_np(rng.uniform(-2.5, 2.5, 3))
    sel = rng.permutation(nm)[:nd]
    data = (model[sel] - rng.uniform(-2, 2, 3)) @ R + [-3.0, 4.0, 1.0]
    mp = rng.integers(0, 9, nm)
    return (f"tst{seed:02d}", np.round(data, 6), np.round(model, 6),
            mp[sel], mp, np.round(model[sel], 6))


def write_pipe_root(root: str) -> None:
    from goicp_tpu_torch.bench import bo1_files
    bo1_files.write_bo1_root(root, [pipe_pair(10, 48, 40),
                                    pipe_pair(11, 56, 48)])


SWEEP_KEYS = ("error", "outer_steps", "bound_evals", "icp_runs", "converged",
              "rmsd")


def stream_pairs(cfg, device, n: int = 3):
    """The port's prepared stream pairs: one bucket, count-dynamic."""
    raw = stream_clouds(n)
    dims: dict = {}
    for data, model, _, _ in raw:
        d = bucket_dims(model, len(data), len(model), cfg)
        dims = {k: max(dims.get(k, 0), v) for k, v in d.items()}
    return [make_count_dynamic(prepare_pair(d, m, dp, mp, cfg, device=device,
                                            **dims))
            for d, m, dp, mp in raw]


def static_pairs(cfg, device):
    """tests/test_torch_pair.py's register_batch pairs: static, one shape."""
    from goicp_tpu_torch.geom.normalize import normalize_pair
    pairs = []
    for seed in (3, 4):
        _, data, model, dp, mp, _ = pipe_pair(seed, 36, 28)
        norm = normalize_pair(data, model)
        pairs.append(prepare_pair(norm["source"], norm["target"], dp, mp,
                                  cfg, pad_data_to=32, pad_model_to=64,
                                  pad_cells=64, pad_points=8, device=device))
    return pairs


@contextlib.contextmanager
def one_rank_mesh():
    """A 1 x 1 mesh over a one-rank gloo group of this process, the group
    destroyed on exit: the mesh= code paths without spawning ranks."""
    import torch.distributed as dist

    from goicp_tpu_torch.dist.mesh import init_distributed, make_mesh
    from goicp_tpu_torch.dist.spawn import _free_port
    init_distributed(f"localhost:{_free_port()}", 1, 0, device="cpu",
                     timeout_s=120)
    try:
        yield make_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _fields(prefix: str, res) -> dict:
    return {f"{prefix}.{k}": torch.as_tensor(v).cpu().numpy()
            for k, v in res._asdict().items()}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def dist_ranks(device) -> dict:
    """sharded_inner_step at every layout, put_global and reduce_best on a
    2 x 2 mesh, and dryrun_multichip(4); 4 ranks."""
    from goicp_tpu_torch.dist.dryrun import dryrun_multichip
    from goicp_tpu_torch.dist.mesh import (make_mesh, put_global,
                                           reduce_best, sharded_inner_step,
                                           stack_pairs)
    import torch.distributed as dist

    cfg = GoICPConfig(**INNER_CFG)
    out = {}
    for n_data, n_search in INNER_LAYOUTS:
        mesh = make_mesh(n_data, n_search, device=device)
        if mesh is None:
            continue
        pairs = [prepare_pair(*inner_clouds(s), inner_clouds(s)[2], cfg,
                              pad_cells=24, pad_points=8, device=device)
                 for s in range(n_data)]
        pts, widths, active, opt = (torch.as_tensor(a, device=device)
                                    for a in inner_inputs(n_data))
        res = sharded_inner_step(mesh, cfg, with_rot_uncertainty=False)(
            stack_pairs(pairs), pts, widths, active, opt)
        out.update(_fields(f"inner{n_data}x{n_search}", res))
    mesh = make_mesh(2, 2, device=device)
    rows = torch.arange(8, device=device).reshape(4, 2)
    out["put_rows"] = put_global(rows, mesh).cpu().numpy()
    out["put_pairs"] = put_global(stack_pairs([
        prepare_pair(d, m, p, p, cfg, pad_cells=24, pad_points=8,
                     device=device)
        for d, m, p in map(inner_clouds, range(2))]), mesh).data.numpy()
    errs = torch.as_tensor(np.random.default_rng(dist.get_rank())
                           .uniform(0, 1, 5), dtype=torch.float32,
                           device=device)
    out.update(errs=errs.cpu().numpy(),
               best_search=reduce_best(errs, mesh, "search").cpu().numpy(),
               best_data=reduce_best(errs, mesh, "data").cpu().numpy())
    out.update({f"dryrun.{k}": v
                for k, v in dryrun_multichip(4, device=device).items()})
    return out


def sharded_ranks(device) -> dict:
    """8 ranks, each row of a mesh running its own search over its search
    group: register_device with the lanes over 4 ranks beside
    register_device_sharded's optimum case (4 ranks, rebalanced every
    step); the skew case static and rebalanced every 2 steps (4 ranks
    each); the cadences case rebalanced every 1 and 4 steps (2 ranks
    each).  Keys name the run; every rank of its row returns it."""
    from goicp_tpu_torch.dist.mesh import make_mesh
    from goicp_tpu_torch.search.device_engine import register_device
    from goicp_tpu_torch.search.sharded_engine import register_device_sharded

    def sharded(name, mesh, k):
        cfg, pair = sharded_case(name, device)
        return _fields(f"{name}{k}", register_device_sharded(
            pair, cfg, mesh, rebalance_every=k))

    mesh = make_mesh(2, 4, device=device)
    if mesh.data_rank == 0:
        cfg = GoICPConfig(**LANE_CFG)
        pair = prepare_pair(*noisy_clouds(11, 0.02), cfg, **PAD,
                            device=device)
        out = _fields("lane", register_device(pair, cfg, mesh=mesh))
    else:
        out = sharded("optimum", mesh, 1)
    out.update(sharded("skew", make_mesh(2, 4, device=device),
                       (0, 2)[mesh.data_rank]))
    mesh = make_mesh(4, 2, device=device)
    if mesh.data_rank < 2:
        out.update(sharded("cadences", mesh, (1, 4)[mesh.data_rank]))
    return out


def straggler_ranks(device, row_path: str, out_dir: str) -> dict:
    """4 ranks: the straggler handoff of the mid-flight fused row in
    row_path over a 1 x 4 mesh; over a 2 x 2 mesh the fused stream, the
    batch and the compacting batch, the last two also stopped after one
    chunk and resumed from their per-rank checkpoints; the BO1 sweep of
    both runners into out_dir/<runner> (only rank 0 writes) and
    register_batch."""
    import torch.distributed as dist

    from goicp_tpu_torch.dist.mesh import make_mesh
    from goicp_tpu_torch.pipeline.batch_sweep import register_batch
    from goicp_tpu_torch.pipeline.device_sweep import run_sweep_device_batch
    from goicp_tpu_torch.search import fused_stream as fs
    from goicp_tpu_torch.search.chunked import register_device_batch_compact
    from goicp_tpu_torch.search.device_engine import register_device_batch

    cfg = GoICPConfig(**STREAM_CFG)
    pairs = stream_pairs(cfg, device)
    with np.load(row_path) as z:
        row = fs._unflatten_state(dict(z), device)
    out = _fields("handoff", fs.straggler_to_lane_sharded(
        pairs[2], cfg, row, make_mesh(1, 4, device=device)))
    mesh = make_mesh(2, 2, device=device)
    out.update(_fields("stream", fs.register_fused_stream(
        pairs, cfg, width=2, chunk_steps=16, mesh=mesh)))
    out.update(_fields("batch", register_device_batch(pairs, cfg,
                                                      mesh=mesh)))
    out.update(_fields("compact", register_device_batch_compact(
        pairs, cfg, chunk_steps=8, mesh=mesh)))
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in (
                ("compact", lambda **kw: register_device_batch_compact(
                    pairs, cfg, chunk_steps=8, mesh=mesh, **kw)),
                ("stream", lambda **kw: fs.register_fused_stream(
                    pairs, cfg, width=2, chunk_steps=16, mesh=mesh, **kw))):
            path = os.path.join(tmp, f"{name}.npz")
            try:
                run(checkpoint_path=path, max_chunks=1)
                out[f"{name}_stopped"] = False
            except RuntimeError:
                out[f"{name}_stopped"] = True
            out.update(_fields(f"{name}_resumed", run(checkpoint_path=path,
                                                      resume=True)))

    # the pipelines over the same mesh
    pcfg = GoICPConfig(**PIPE_CFG)
    with tempfile.TemporaryDirectory() as root:
        write_pipe_root(root)
        for runner in ("compact", "fused"):
            rows = run_sweep_device_batch(
                root, pcfg, os.path.join(out_dir, runner), runner=runner,
                mesh=mesh, device=device)
            for k in SWEEP_KEYS:
                out[f"sweep_{runner}.{k}"] = np.array(
                    [np.nan if r[k] is None else r[k] for r in rows],
                    np.float64)
    batch = register_batch(static_pairs(pcfg, device), pcfg, slots=2,
                           mesh=mesh)
    out["register_batch.error"] = np.array([r.error for r in batch])
    out["register_batch.outer_steps"] = np.array([r.outer_steps
                                                  for r in batch])
    out["rank"] = dist.get_rank()
    return out
