"""BO1 sweep on the batched engines: many DISTINCT pairs registered
together.

Port of goicp_tpu/pipeline/device_sweep.py.  The sweep's runnable pairs
are grouped into shape buckets by their own kernel dims
(prepare.plan_buckets, up to 3), their REAL point counts moved into the
`counts` tensor (prepare.make_count_dynamic), and each bucket's pairs
registered in chunks of `batch_size` by one of two runners: "compact"
(`run-bo1 --engine device-batch`: search/chunked.py::
register_device_batch_compact, the batch compacted as its pairs converge;
a bucket's ragged later chunks padded to batch_size with pre-converged
rows) or "fused" (search/fused_stream.py::register_fused_stream, width 2,
512-step chunks).  Trajectories do not depend on the padding, so every
pair's result equals its own register_device run.

Outputs are those of the per-pair sweep: output/<kind><k>.txt,
*_rescaled.txt, cavitiesN clouds, rot proteins + resultsRMSD.txt, and one
JSONL row per pair.

With a mesh (dist/mesh.py) every rank runs the sweep on the same pairs and
the runners split the pair axis over its `data` axis; only global rank 0
writes files (the other ranks' rows have no RMSD).
"""

from __future__ import annotations

import os
import time

import numpy as np

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.io.mol2 import mol2_atom_count
from goicp_tpu_torch.pipeline.pair import (adapt_device_result,
                                           finish_pair_run, load_pair_inputs)
from goicp_tpu_torch.pipeline.prepare import (bucket_dims, make_count_dynamic,
                                              plan_buckets, prepare_pair)
from goicp_tpu_torch.pipeline.sweep import (append_row, cavity_files,
                                            resolve_device, sweep_pairs)

FUSED_WIDTH = 2      # the fused stream's window
FUSED_CHUNK = 512    # global iterations between the stream's host checks
MAX_BUCKETS = 3


def run_sweep_device_batch(data_root: str, cfg: GoICPConfig, out_dir: str,
                           kind: str = "similar",
                           limit: int | None = None, start: int = 0,
                           resume: bool = True, with_rmsd: bool = True,
                           batch_size: int = 64, verbose: bool = False,
                           runner: str = "compact", device=None,
                           mesh=None):
    """data_root: reference-data layout (cavities/, cfpfh/, chains/,
    ref_proteins/, BO1 tsv files).  runner: "compact" (the convergence-
    compacted batch, search/chunked.py) or "fused" (the cross-pair fused
    stream).  device: None means goicp_tpu_torch.default_device(), the
    card (with a mesh: the mesh's device).  mesh: every rank of it calls
    this with the same arguments; the pairs split over its `data` axis
    and only global rank 0 writes files."""
    if runner not in ("compact", "fused"):
        raise ValueError(f"unknown runner {runner!r}")
    from goicp_tpu_torch.search.chunked import register_device_batch_compact
    from goicp_tpu_torch.search.fused_stream import register_fused_stream

    fused_width = FUSED_WIDTH
    writer = True
    if mesh is not None:
        import torch.distributed as dist
        device = device or mesh.device
        # the stream's window splits over `data`: a multiple of its size
        fused_width = -(-max(FUSED_WIDTH, mesh.n_data) // mesh.n_data) \
            * mesh.n_data
        writer = dist.get_rank() == 0
    device = resolve_device(device)
    if writer:
        os.makedirs(out_dir, exist_ok=True)
    results_path = os.path.join(out_dir, f"results_{kind}.jsonl") \
        if writer else os.devnull

    # ---- load + normalize every runnable pair (host) ----
    runnable = []      # (k, src, tgt, inputs, n_downsampled, out_file)
    for k, src, tgt in sweep_pairs(data_root, kind, start, limit):
        out_file = os.path.join(out_dir, "output", f"{kind}{k}.txt")
        if resume and os.path.exists(out_file):
            continue
        files = cavity_files(data_root, src, tgt, kind, k, results_path)
        if files is None:
            continue
        data_file, model_file = files
        inputs = load_pair_inputs(model_file, data_file, cfg, pair_id=k,
                                  out_dir=out_dir if writer else None,
                                  cfpfh_dir=os.path.join(data_root, "cfpfh")
                                  if cfg.cfpfh != 0 else None)
        runnable.append((k, src, tgt, inputs, mol2_atom_count(data_file),
                         out_file))
    if not runnable:
        return []

    # ---- shape buckets over the sweep, each pair prepared into its own
    # bucket's dims and made count-dynamic ----
    dims_list = []
    for _, _, _, inputs, n_ds, _ in runnable:
        nd = min(n_ds, len(inputs.src_n)) if n_ds > 0 else len(inputs.src_n)
        dims_list.append(bucket_dims(inputs.tgt_n, nd, len(inputs.tgt_n),
                                     cfg))
    plan = plan_buckets(dims_list, max_buckets=MAX_BUCKETS)
    prepared = {}
    for bd, idxs in plan:
        for i in idxs:
            _, _, _, inputs, n_ds, _ = runnable[i]
            prepared[i] = make_count_dynamic(prepare_pair(
                inputs.src_n, inputs.tgt_n, inputs.src_props,
                inputs.tgt_props, cfg, inputs.src_fpfh, inputs.tgt_fpfh,
                nd_downsampled=n_ds, device=device, **bd))

    # ---- each bucket's pairs in chunks of batch_size through the runner
    results = []
    for _, idxs in plan:
        for lo in range(0, len(idxs), batch_size):
            chunk_idxs = idxs[lo:lo + batch_size]
            chunk = [prepared[i] for i in chunk_idxs]
            t0 = time.time()
            if runner == "fused":
                out = register_fused_stream(chunk, cfg, width=fused_width,
                                            chunk_steps=FUSED_CHUNK,
                                            mesh=mesh)
            else:
                # a bucket's later ragged chunk pads to batch_size with
                # pre-converged rows (they never search); its first
                # chunk runs at its own width
                out = register_device_batch_compact(
                    chunk, cfg, mesh=mesh, pad_to=batch_size
                    if len(chunk) < batch_size and lo > 0 else None)
            wall = time.time() - t0
            per_pair_s = wall / len(chunk)
            for j, i in enumerate(chunk_idxs):
                k, src, tgt, inputs, _, out_file = runnable[i]
                row_res = type(out)(*(leaf[j] for leaf in out))
                n_data = int(np.sum(chunk[j].data_mask.cpu().numpy() > 0))
                reg = adapt_device_result(row_res, n_data, per_pair_s)
                rmsd = with_rmsd and writer
                res = finish_pair_run(
                    inputs, reg, output_file=out_file if writer else None,
                    out_dir=out_dir if writer else None,
                    chains_dir=os.path.join(data_root, "chains")
                    if rmsd else None,
                    ref_proteins_dir=os.path.join(data_root, "ref_proteins")
                    if rmsd else None)
                row = dict(pair=k, kind=kind, source=src, target=tgt,
                           error=reg.error, geom_error=reg.geom_error,
                           incomp_error=reg.incomp_error,
                           fpfh_error=reg.fpfh_error,
                           compatibilities=reg.compatibilities,
                           rmsd=res.rmsd, time_s=per_pair_s,
                           outer_steps=reg.outer_steps,
                           bound_evals=reg.bound_evals,
                           icp_runs=reg.icp_runs, converged=reg.converged,
                           gap=reg.gap, engine="fused" if runner == "fused"
                           else "device-batch", batch=len(chunk),
                           batch_wall_s=wall)
                results.append(row)
                append_row(results_path, row)
                if verbose:
                    print(f"[{k}] {src} -> {tgt}: err {reg.error:.4f} "
                          f"comp {reg.compatibilities} rmsd {res.rmsd} "
                          f"({per_pair_s:.3f}s/pair in batch {len(chunk)})")
    return results
