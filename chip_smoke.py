#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (goicp_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (nonzero exit, no result line):

 1. setup: the card's name and power limit (nvidia-smi), TF32 off, and the
    CUDA kernels of goicp_tpu_torch/csrc built with nvcc (build time on its
    own line, then each kernel's registers, shared memory and spills as
    ptxas reports them).
 2. kernels vs plain: each kernel's wrapper on card tensors at main-path
    shapes (a prepared bench pair, lanes/centers/widths from a numpy seed),
    held against its plain torch version on the same inputs: K1 untrimmed
    (fused and plain modes) to atol 1e-5, K1 with the dynamic K read from
    counts[1] to rtol 1e-5 / atol 1e-4, K2 at Q=152 and Q=8 exactly.  Median
    kernel and plain times over 25 launches each, from CUDA events.
 3. registrations through the port's entry points: prepare_pair(bucket=
    True) -> make_count_dynamic -> register_device, under GoICPConfig() +
    bench_shape, on six pairs of the similar pool and four of the trimmed
    pool.  Each is held against the fp32 reference rows (the JAX package's
    register_device on XLA:CPU, goicp_tpu_torch/bench/reference_rows.jsonl)
    and printed beside its sweep383*.jsonl row.
 4. proof: both kernels' launch counters, zeroed just before phase 3, are
    > 0 after it.

The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda:0"
SIMILAR = ["syn00", "syn01", "syn05", "syn06", "syn13", "syn07"]
TRIMMED = ["trm00", "trm01", "trm03", "trm13"]
ERR_TOL = 1e-4          # |error - reference error|
TRIM_EVALS_REL = 0.05   # trimmed pairs: evals within 5 % of the reference


def _require(ok, what):
    """A failed check ends the run (a plain raise, kept under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _rows(path):
    with open(path) as fh:
        return {r["pair"]: r for r in map(json.loads, fh) if r}


def _median_ms(fn, n=25):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def _prepared(name, cfg, pools, dev):
    from goicp_tpu_torch.bench.measure import _normalized_synthetic
    from goicp_tpu_torch.pipeline.prepare import (make_count_dynamic,
                                                  prepare_pair)
    data, model, dp, mp = _normalized_synthetic(pools[name])
    return make_count_dynamic(prepare_pair(data, model, dp, mp, cfg,
                                           bucket=True, device=dev))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import goicp_tpu_torch
    from goicp_tpu_torch import _build
    from goicp_tpu_torch.bench.measure import (TRIM_FRACTION, bench_shape,
                                               synthetic_pool,
                                               synthetic_pool_trimmed)
    from goicp_tpu_torch.bounds import cuda_eval
    from goicp_tpu_torch.bounds.evaluate import rot_uncertainty
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    from goicp_tpu_torch.search.device_engine import register_device

    # ---- 1. setup ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)          # the card's name and power limit
    _require(not torch.backends.cuda.matmul.allow_tf32
             and not torch.backends.cudnn.allow_tf32, "TF32 is off")
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}", flush=True)
    t0 = time.perf_counter()
    _build.library(ptxas_verbose=True)
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"({_build.build_info['path']})", flush=True)
    for line in _build.build_info["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    cfg = bench_shape(goicp_tpu_torch.GoICPConfig())
    cfg_t = dataclasses.replace(cfg, trimFraction=TRIM_FRACTION,
                                trans_capacity=256)
    pools = {e[0]: e for e in synthetic_pool(64, seed=7)}
    pools.update({e[0]: e for e in synthetic_pool_trimmed(32, seed=23)})

    # ---- 2. kernels vs plain at main-path shapes ----
    rng = np.random.default_rng(2026)
    kernels = {
        "geometric_bounds_kernel": dict(
            source="goicp_tpu_torch/csrc/geom_bounds.cu",
            replaces="goicp_tpu/bounds/pallas_eval.py:517", errs=[]),
        "chem_incomp_kernel": dict(
            source="goicp_tpu_torch/csrc/chem_incomp.cu",
            replaces="goicp_tpu/bounds/pallas_eval.py:702", errs=[]),
    }
    L, B = 8, cfg.trans_pop * 8
    for name, c in (("syn07", cfg), ("trm00", cfg_t)):
        pair = _prepared(name, c, pools, dev)
        nd = pair.n_data_padded
        rots = np.stack([rodrigues_np(v)
                         for v in rng.uniform(-2.5, 2.5, (L, 3))])
        pts = torch.as_tensor(
            np.einsum("lij,nj->lni", rots, pair.data.cpu().numpy()),
            dtype=torch.float32, device=dev).contiguous()
        centers = torch.as_tensor(rng.uniform(-0.5, 0.5, (L, B, 3)),
                                  dtype=torch.float32, device=dev)
        widths = torch.as_tensor(rng.uniform(0.03, 0.5, (L, B)),
                                 dtype=torch.float32, device=dev)
        unc = rot_uncertainty(torch.as_tensor(rng.uniform(0.05, 1.0, L),
                                              dtype=torch.float32,
                                              device=dev),
                              pair.norm_data).contiguous()
        g = pair.grid
        base = (pts, centers, widths)
        tabs = (pair.weights, g.cell_coords, g.consts)
        kw = dict(size=g.geom.size, norm=cfg.norm)
        if name == "syn07":
            cases = [("fused", unc, dict(fused=True), 1e-5, 0.0),
                     ("plain+unc", unc, {}, 1e-5, 0.0),
                     ("plain", None, {}, 1e-5, 0.0)]
        else:
            k = pair.inlier_f()
            cases = [("fused K=counts[1]", unc,
                      dict(fused=True, trim_count=k), 1e-4, 1e-5),
                     ("plain+unc K=counts[1]", unc, dict(trim_count=k),
                      1e-4, 1e-5)]
        for label, ru, extra, atol, rtol in cases:
            def kern(ru=ru, extra=extra):
                return cuda_eval.geometric_bounds_kernel(
                    *base, ru, *tabs, **kw, **extra)

            def plain(ru=ru, extra=extra):
                return cuda_eval.geometric_bounds_plain(
                    *base, ru, *tabs, **kw, **extra)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, atol=atol, rtol=rtol)
            err = _max_err(got, want)
            kernels["geometric_bounds_kernel"]["errs"].append(err)
            ms, pms = _median_ms(kern), _median_ms(plain)
            if label == "fused":
                kernels["geometric_bounds_kernel"].update(ms=ms, plain_ms=pms)
            print(f"K1 {name} {label}: L={L} B={B} Nd={nd} "
                  f"C={g.cell_coords.shape[0]} max_abs_err={err:.3g} "
                  f"(atol {atol}, rtol {rtol}) kernel {ms:.4f} ms "
                  f"plain {pms:.4f} ms", flush=True)
        for q in (cfg.trans_pop * 19, 8):
            corners = torch.as_tensor(rng.uniform(-0.6, 0.6, (L, q, 3)),
                                      dtype=torch.float32, device=dev)
            cargs = (pts, corners, pair.cell_compat, pair.prop_onehot,
                     pair.data_mask, g.cell_coords, g.consts)

            def kern2(cargs=cargs):
                return cuda_eval.chem_incomp_kernel(*cargs, size=g.geom.size)

            def plain2(cargs=cargs):
                return cuda_eval.chem_incomp_plain(*cargs, size=g.geom.size)
            got, want = kern2(), plain2()
            torch.cuda.synchronize()
            _require(torch.equal(got, want), f"K2 == plain ({name}, Q={q})")
            err = _max_err([got], [want])
            kernels["chem_incomp_kernel"]["errs"].append(err)
            ms, pms = _median_ms(kern2), _median_ms(plain2)
            if name == "syn07" and q == cfg.trans_pop * 19:
                kernels["chem_incomp_kernel"].update(ms=ms, plain_ms=pms)
            print(f"K2 {name} Q={q}: L={L} Nd={nd} "
                  f"C={g.cell_coords.shape[0]} max_abs_err={err:.3g} "
                  f"(exact) kernel {ms:.4f} ms plain {pms:.4f} ms",
                  flush=True)

    # ---- 3. registrations (the main path) ----
    ref = _rows(os.path.join(REPO, "goicp_tpu_torch", "bench",
                             "reference_rows.jsonl"))
    sweep = _rows(os.path.join(REPO, "sweep383.jsonl"))
    sweep.update(_rows(os.path.join(REPO, "sweep383_trimmed.jsonl")))
    cuda_eval.reset_launch_counts()
    for name in SIMILAR + TRIMMED:
        c = cfg if name.startswith("syn") else cfg_t
        t0 = time.perf_counter()
        pair = _prepared(name, c, pools, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = register_device(pair, c)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        got = dict(error=float(r.error), converged=bool(r.converged),
                   outer=int(r.outer_iters), inner=int(r.inner_iters),
                   evals=int(r.evals), icp_runs=int(r.icp_runs))
        want, row = ref[name], sweep[name]
        row_match = all(got[k] == row[k]
                        for k in ("outer", "inner", "evals", "icp_runs"))
        print(f"{name}: prepare {t1 - t0:.3f} s, register {t2 - t1:.3f} s | "
              f"port {json.dumps(got)} | fp32 reference "
              f"{json.dumps({k: want[k] for k in got})} | sweep row "
              f"{json.dumps({k: row[k] for k in got})} "
              f"counters_match_row={row_match}", flush=True)
        _require(got["converged"], f"{name} converged")
        _require(abs(got["error"] - want["error"]) <= ERR_TOL,
                 f"{name} error {got['error']} vs {want['error']}")
        if name.startswith("syn"):
            for k in ("outer", "inner", "evals", "icp_runs"):
                _require(got[k] == want[k] == row[k],
                         f"{name} {k}: port {got[k]}, reference {want[k]}, "
                         f"sweep row {row[k]}")
        else:
            _require(abs(got["evals"] - want["evals"])
                     <= TRIM_EVALS_REL * want["evals"],
                     f"{name} evals {got['evals']} vs {want['evals']}")
    counts = cuda_eval.launch_counts()

    # ---- 4. proof the main path ran the kernels ----
    print(f"launches during the registrations: {json.dumps(counts)}",
          flush=True)
    for kname, n in counts.items():
        _require(n > 0, f"{kname} launched on the main path")

    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": counts[kname],
         "max_abs_err": max(k["errs"]), "ms": k["ms"],
         "plain_ms": k["plain_ms"]} for kname, k in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
