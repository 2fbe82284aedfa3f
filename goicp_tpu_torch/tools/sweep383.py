"""The BO1-scale sweeps: up to 383 pairs through the fused stream, one
stream per shape bucket, with JSONL rows, checkpoints and resume.

Port of tools/sweep383.py.  The reference registers BO1's 383 similar
pairs (bo1_GoICP.py:40-54) and carries 383 dissimilar ones for the trimmed
workload (trimFraction, READMEGo-ICP.md:82-84).  Without the reference
data the similar pool is syn00, syn01, ... (bench/measure.synthetic_pool);
with it, the two real BO1 pairs come first.  --trimmed switches to the
noisy pool trm00, trm01, ... under trimFraction=0.1 and a 256-node
translation frontier.

    python -m goicp_tpu_torch.tools.sweep383 [--n 383] [--width 2]
        [--chunk-steps 512] [--buckets 3] [--trimmed] [--out ROWS.jsonl]
        [--ckpt DIR] [--kill-after-chunks N] [--ckpt-every 8] [--verbose]
        [--reference DIR | --no-reference] [--device cpu]

Checkpoints: DIR (default `.sweep383_torch_<similar|trimmed>/` at the
repository's root) holds manifest.json (the run's identity: n, trimmed,
buckets, width, chunk_steps, the reference flag, every GoICPConfig field
and each bucket's original indices), b<K>.npz (bucket K's in-flight stream
state, every --ckpt-every chunks and at a stop), b<K>.done.npz (a finished
bucket's results) and walls.json (the registration seconds of earlier
processes).  A run over an existing DIR resumes: finished buckets are
read back and the interrupted one continues from its state.  A manifest
that differs from the run's raises ValueError naming the field, and
leaves the files as they are.  --kill-after-chunks N stops each bucket's
stream after N chunks, state saved, and exits 3; run again without it to
resume.  Only that stop exits 3: any other error propagates.  After a
sweep passes its gates the files it wrote in DIR are removed.

Gates, as the bench holds them (bench/measure._check_parity): every pair
converged, the margin guard, each pair with an fp32 row (the bench's 96
and syn64-syn79, trm32-trm39) within 1e-4 of its error, similar counters
equal to the row, trimmed evals within 5 %; with the reference data, BO1
pair 1's golden error and compatibilities.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from goicp_tpu_torch.bench import measure
from goicp_tpu_torch.bounds import cuda_eval
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.search.device_engine import DeviceResult
from goicp_tpu_torch.search.fused_stream import (StreamStopped,
                                                 register_fused_stream)
from goicp_tpu_torch.utils.npz import savez_exact

REPO = measure.REPO
_MANIFEST = "manifest.json"
_WALLS = "walls.json"
# the kernels a stream launches besides the transitions' (K3/K4's bodies
# run inside the inner step)
_STREAM_KERNELS = ("chem_incomp_kernel", "inner_step")


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, indent=1)
    os.replace(tmp, path)


def _check_manifest(ckpt_dir: str, manifest: dict) -> None:
    """Write the run's manifest into ckpt_dir, or, when one is there,
    raise ValueError unless it equals the run's."""
    path = os.path.join(ckpt_dir, _MANIFEST)
    if not os.path.exists(path):
        _write_json(path, manifest)
        return
    with open(path) as fh:
        old = json.load(fh)
    differ = sorted(k for k in set(old) | set(manifest)
                    if old.get(k) != manifest.get(k))
    if differ:
        raise ValueError(
            f"{ckpt_dir} holds the checkpoints of another sweep: "
            f"{', '.join(differ)} differ ({path}); pass another --ckpt, "
            f"or remove the directory to start afresh")


def _walls(ckpt_dir: str) -> float:
    """The registration seconds that earlier processes spent on the
    sweep in ckpt_dir."""
    path = os.path.join(ckpt_dir, _WALLS)
    if not os.path.exists(path):
        return 0.0
    with open(path) as fh:
        return json.load(fh)["registration_s"]


def _sweep_files(ckpt_dir: str, n_buckets: int) -> list:
    return [os.path.join(ckpt_dir, f) for f in (_MANIFEST, _WALLS)] + \
        [os.path.join(ckpt_dir, f"b{bi}{ext}") for bi in range(n_buckets)
         for ext in (".npz", ".done.npz")]


def cleanup(ckpt_dir: str, n_buckets: int) -> None:
    """Remove the files a sweep of n_buckets buckets writes in ckpt_dir,
    then the directory if that left it empty."""
    for p in _sweep_files(ckpt_dir, n_buckets):
        if os.path.exists(p):
            os.unlink(p)
    if os.path.isdir(ckpt_dir) and not os.listdir(ckpt_dir):
        os.rmdir(ckpt_dir)


def row_of(name: str, out: DeviceResult, i: int) -> dict:
    """Pair i of a DeviceResult as a sweep row: the JAX tool's 12 fields,
    in its order, floats rounded to 6 digits."""
    def f(v):
        return round(float(v), 6)
    terms = np.asarray(out.terms[i])
    return {"pair": name, "error": f(out.error[i]), "geom": f(terms[0]),
            "incomp": f(terms[1]), "fpfh": f(terms[2]),
            "compat": int(out.opt_comp[i]), "gap": f(out.gap[i]),
            "converged": bool(out.converged[i]),
            "outer": int(out.outer_iters[i]),
            "inner": int(out.inner_iters[i]), "evals": int(out.evals[i]),
            "icp_runs": int(out.icp_runs[i])}


def run_sweep(buckets, names, cfg: GoICPConfig, out_path: str,
              ckpt_dir: str, *, width: int = measure.FUSED_WIDTH,
              chunk_steps: int = measure.FUSED_CHUNK,
              kill_after_chunks: int | None = None, ckpt_every: int = 8,
              progress=None, key: dict | None = None):
    """Register every bucket [(pairs, original indices)] through its own
    fused stream, resuming from ckpt_dir, and write one row per pair to
    out_path in pool order.  key: the run's identity beyond what the
    arguments show (main: trimmed, buckets, reference), kept in the
    manifest.  A bucket stopped by kill_after_chunks raises StreamStopped
    with its state saved.  Returns (rows, DeviceResult of numpy arrays in
    pool order, registration seconds of this and earlier processes)."""
    dev = buckets[0][0][0].device
    os.makedirs(ckpt_dir, exist_ok=True)
    _check_manifest(ckpt_dir, dict(
        key or {}, n=len(names), width=width, chunk_steps=chunk_steps,
        config=dataclasses.asdict(cfg),
        bucket_indices=[[int(i) for i in idxs] for _, idxs in buckets]))
    earlier = _walls(ckpt_dir)
    outs = []
    t0 = time.perf_counter()
    try:
        for bi, (bp, idxs) in enumerate(buckets):
            done_path = os.path.join(ckpt_dir, f"b{bi}.done.npz")
            if os.path.exists(done_path):
                with np.load(done_path) as z:
                    out = DeviceResult(*(z[f] for f in DeviceResult._fields))
                print(f"bucket {bi}: {len(idxs)} pairs already done "
                      f"(resume)", flush=True)
            else:
                ckpt = os.path.join(ckpt_dir, f"b{bi}.npz")
                out = register_fused_stream(
                    bp, cfg, width=width, chunk_steps=chunk_steps,
                    checkpoint_path=ckpt, resume=True,
                    max_chunks=kill_after_chunks, progress=progress,
                    checkpoint_every=ckpt_every)
                savez_exact(done_path, {f: np.asarray(getattr(out, f))
                                        for f in DeviceResult._fields})
                if os.path.exists(ckpt):
                    os.unlink(ckpt)
            outs.append((idxs, out))
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        reg_s = earlier + time.perf_counter() - t0
        _write_json(os.path.join(ckpt_dir, _WALLS),
                    {"registration_s": reg_s})
    res = measure._reassemble(outs, len(names))
    rows = [row_of(n, res, i) for i, n in enumerate(names)]
    with open(out_path, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    return rows, res, reg_s


def default_paths(trimmed: bool) -> tuple:
    """(rows, checkpoint directory) when --out / --ckpt are not given: at
    the repository's root, under names .gitignore lists, never a file of
    the JAX tool (sweep383.jsonl, sweep383_trimmed.jsonl,
    .sweep383_*.npz*)."""
    tag = "trimmed" if trimmed else "similar"
    return (str(REPO / f"sweep383_torch_{tag}.jsonl"),
            str(REPO / f".sweep383_torch_{tag}"))


def _progress(p):
    inflight = [r for r in p["rows"] if not r["dead"]]
    best = min((r["incumbent"] for r in inflight), default=float("nan"))
    print(f"chunk {p['chunk']:4d}: in-flight="
          f"{[r['pair'] for r in inflight]} "
          f"outer={[r['outer'] for r in inflight]} "
          f"best_incumbent={best:.3f}", flush=True)


def _device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        return measure._nvidia_smi(dev.index or 0)
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(dev) + ", power limit unknown"


def _parser():
    ap = argparse.ArgumentParser(prog="python -m goicp_tpu_torch.tools."
                                      "sweep383")
    ap.add_argument("--n", type=int, default=383)
    ap.add_argument("--width", type=int, default=measure.FUSED_WIDTH)
    ap.add_argument("--chunk-steps", type=int, default=measure.FUSED_CHUNK)
    ap.add_argument("--buckets", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="rows (default: sweep383_torch_<tag>.jsonl at the "
                         "repository's root)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: "
                         ".sweep383_torch_<tag>/ at the repository's root)")
    ap.add_argument("--trimmed", action="store_true",
                    help="the trimmed pool (trimFraction=0.1) instead of "
                         "the similar pool")
    ap.add_argument("--kill-after-chunks", type=int, default=None,
                    help="stop each bucket's stream after N chunks, state "
                         "saved, and exit 3")
    ap.add_argument("--verbose", action="store_true",
                    help="a line per chunk (each reads the window state)")
    ap.add_argument("--ckpt-every", type=int, default=8)
    ref = ap.add_mutually_exclusive_group()
    ref.add_argument("--reference", default=measure.REF,
                     help="the BO1 reference data directory (cavities/, "
                          "config.txt)")
    ref.add_argument("--no-reference", dest="reference",
                     action="store_const", const=None,
                     help="the synthetic pools alone")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    """Run one sweep (see the module docstring).  Returns 0, or 3 after
    the stop --kill-after-chunks asked for."""
    from goicp_tpu_torch import default_device

    args = _parser().parse_args(argv)
    dev = torch.device(args.device) if args.device else default_device()
    ref_dir = args.reference
    if ref_dir is not None and not os.path.isdir(ref_dir):
        raise FileNotFoundError(
            f"reference directory {ref_dir} not found (pass "
            "--no-reference to sweep the synthetic pools alone)")
    tag = "trimmed" if args.trimmed else "similar"
    out_path, ckpt_dir = default_paths(args.trimmed)
    out_path, ckpt_dir = args.out or out_path, args.ckpt or ckpt_dir
    cfg = measure.bench_shape(GoICPConfig.from_file(f"{ref_dir}/config.txt")
                              if ref_dir else GoICPConfig())
    if args.trimmed:
        cfg = dataclasses.replace(cfg, trimFraction=measure.TRIM_FRACTION,
                                  trans_capacity=256)

    t0 = time.perf_counter()
    if args.trimmed:
        buckets = measure.build_trimmed_batch_buckets(
            cfg, args.n, max_buckets=args.buckets, device=dev)
        names = [f"trm{i:02d}" for i in range(args.n)]
    else:
        buckets = measure.build_batch_buckets(
            cfg, args.n, max_buckets=args.buckets, ref_dir=ref_dir,
            device=dev)
        names = measure.similar_names(args.n, ref_dir)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prep_s = time.perf_counter() - t0
    plan = [dict(pairs=len(idxs), Nd=bp[0].n_data_padded,
                 Nm=int(bp[0].model.shape[0]),
                 C=int(bp[0].grid.cell_coords.shape[0]))
            for bp, idxs in buckets]
    print(f"prepared {len(buckets)} bucket(s) over {args.n} {tag} pairs "
          f"in {prep_s:.3f} s: {json.dumps(plan)}", flush=True)

    before = cuda_eval.launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the stop the caller asked for is the only error caught
    stop = StreamStopped if args.kill_after_chunks is not None else ()
    try:
        _, res, reg_s = run_sweep(
            buckets, names, cfg, out_path, ckpt_dir, width=args.width,
            chunk_steps=args.chunk_steps,
            kill_after_chunks=args.kill_after_chunks,
            ckpt_every=args.ckpt_every,
            progress=_progress if args.verbose else None,
            key=dict(trimmed=args.trimmed, buckets=args.buckets,
                     reference=ref_dir is not None))
    except stop as e:
        print(f"KILLED (as requested): {e}; registration so far "
              f"{_walls(ckpt_dir):.3f}s; state in {ckpt_dir}", flush=True)
        return 3
    launches = {k: v - before[k]
                for k, v in cuda_eval.launch_counts().items()
                if k in _STREAM_KERNELS}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    conv = np.asarray(res.converged)
    evals = int(np.sum(res.evals))
    tpu = measure.sweep_rows()
    differ = sorted(measure.sweep_row_differences(res, names, tpu))
    rows = measure.fp32_rows()
    print(f"SWEEP DONE ({tag}): {args.n} pairs, registration wall "
          f"{reg_s:.3f}s = {args.n / reg_s:.4f} pairs/s, prep "
          f"{prep_s:.3f}s, {int(conv.sum())}/{args.n} converged, "
          f"{evals} bound evals ({evals / reg_s:.0f}/s); rows -> "
          f"{out_path}", flush=True)
    print("SWEEP DETAIL " + json.dumps(dict(
        device=_device_line(dev), buckets=plan,
        launches_this_process=launches, max_memory_allocated=peak,
        pairs_with_fp32_row=sum(n in rows for n in names),
        fp32_rows_missed=measure.fp32_row_failures(res, names, rows),
        counters_equal_tpu_row=sum(n in tpu and n not in differ
                                   for n in names),
        counters_differ_from_tpu_row=differ)), flush=True)
    measure._check_parity(res, cfg, measure._ordered(buckets, args.n), names,
                          rows)
    cleanup(ckpt_dir, len(buckets))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
