"""BO1 dataset sweep (the equivalent of bo1_GoICP.py).

Port of goicp_tpu/pipeline/sweep.py.  Reference behaviour
(bo1_GoICP.py:40-68): for every pair (source, target) of the similar or
dissimilar TSV, run
    ./GoICP cavities/<target>.mol2 cavities/<source>.mol2 <N> config.txt
            output/<kind><k>.txt <k>
where <N> is the source cavity's atom count (no actual downsampling).

Beyond the reference: one JSONL row per pair, resume (a pair whose output
file exists is skipped), rows for pairs whose files are missing or whose
registration failed, and the RMSD evaluation in line.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

import torch

from goicp_tpu_torch import default_device
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.io.mol2 import mol2_atom_count
from goicp_tpu_torch.io.tsv import read_pair_list
from goicp_tpu_torch.pipeline.pair import run_pair


def sweep_pairs(data_root: str, kind: str, start: int, limit: int | None):
    """The sweep's [(k, source id, target id)], k the 1-based row number in
    the TSV."""
    pairs = read_pair_list(os.path.join(data_root,
                                        f"cavities_{kind}_BO1_clean.tsv"))
    pairs = pairs[start:start + limit] if limit is not None \
        else pairs[start:]
    return [(start + off + 1, src, tgt) for off, (src, tgt)
            in enumerate(pairs)]


def cavity_files(data_root: str, src: str, tgt: str, kind: str, k: int,
                 results_path: str):
    """(data_file, model_file) of a pair, or None after writing the row of
    a pair whose cavity files are missing (the reference's data holds
    only some of the BO1 cavities; the reference's sweep would stop)."""
    data_file = os.path.join(data_root, "cavities", f"{src}_cavity6.mol2")
    model_file = os.path.join(data_root, "cavities", f"{tgt}_cavity6.mol2")
    missing = [p for p in (data_file, model_file) if not os.path.exists(p)]
    if missing:
        append_row(results_path, dict(
            pair=k, kind=kind, source=src, target=tgt, skipped=True,
            missing=[os.path.basename(m) for m in missing]))
        return None
    return data_file, model_file


def resolve_device(device) -> torch.device:
    """The sweep's device, resolved once before any pair runs: None means
    goicp_tpu_torch.default_device(), which raises without a card."""
    return torch.device(device) if device is not None else default_device()


def append_row(results_path: str, row: dict) -> None:
    with open(results_path, "a") as fh:
        fh.write(json.dumps(row) + "\n")


def run_sweep(data_root: str, cfg: GoICPConfig, out_dir: str,
              kind: str = "similar", limit: int | None = None,
              start: int = 0, resume: bool = True, verbose: bool = False,
              with_rmsd: bool = True, retries: int = 1,
              engine: str = "host", device=None):
    """data_root: directory holding cavities/, cfpfh/, chains/,
    ref_proteins/ and the BO1 tsv files.

    engine: "host" or "device" (one pair at a time, pipeline/pair.py),
    "fused" (the cross-pair fused stream over shape buckets) or
    "device-batch" (the convergence-compacted batch over shape buckets;
    both pipeline/device_sweep.py).
    device: None means goicp_tpu_torch.default_device(), the card."""
    if engine in ("device-batch", "fused"):
        from goicp_tpu_torch.pipeline.device_sweep import \
            run_sweep_device_batch
        return run_sweep_device_batch(
            data_root, cfg, out_dir, kind=kind, limit=limit, start=start,
            resume=resume, with_rmsd=with_rmsd, verbose=verbose,
            runner="fused" if engine == "fused" else "compact",
            device=device)
    if engine not in ("host", "device"):
        raise ValueError(f"unknown engine {engine!r}")
    device = resolve_device(device)

    os.makedirs(out_dir, exist_ok=True)
    results_path = os.path.join(out_dir, f"results_{kind}.jsonl")
    results = []
    for k, src, tgt in sweep_pairs(data_root, kind, start, limit):
        out_file = os.path.join(out_dir, "output", f"{kind}{k}.txt")
        if resume and os.path.exists(out_file):
            continue
        files = cavity_files(data_root, src, tgt, kind, k, results_path)
        if files is None:
            continue
        data_file, model_file = files
        n = mol2_atom_count(data_file)
        t0 = time.time()
        res = None
        for attempt in range(retries + 1):
            try:
                res = run_pair(
                    model_file, data_file, cfg, nd_downsampled=n,
                    output_file=out_file, pair_id=k, out_dir=out_dir,
                    cfpfh_dir=os.path.join(data_root, "cfpfh"),
                    chains_dir=os.path.join(data_root, "chains")
                    if with_rmsd else None,
                    ref_proteins_dir=os.path.join(data_root, "ref_proteins")
                    if with_rmsd else None,
                    verbose=verbose, engine=engine, device=device)
                break
            except Exception as exc:   # one pair's failure ends no sweep
                traceback.print_exc(file=sys.stderr)
                if attempt == retries:
                    append_row(results_path, dict(
                        pair=k, kind=kind, source=src, target=tgt,
                        failed=True, error_msg=str(exc)[:500]))
        if res is None:
            continue
        reg = res.registration
        row = dict(pair=k, kind=kind, source=src, target=tgt,
                   error=reg.error, geom_error=reg.geom_error,
                   incomp_error=reg.incomp_error, fpfh_error=reg.fpfh_error,
                   compatibilities=reg.compatibilities, rmsd=res.rmsd,
                   time_s=time.time() - t0, outer_steps=reg.outer_steps,
                   bound_evals=reg.bound_evals, icp_runs=reg.icp_runs,
                   converged=reg.converged, gap=reg.gap)
        results.append(row)
        append_row(results_path, row)
        if verbose:
            print(f"[{k}] {src} -> {tgt}: err {reg.error:.4f} "
                  f"comp {reg.compatibilities} rmsd {res.rmsd} "
                  f"({row['time_s']:.2f}s)")
    return results
