"""Where one registration's, or one stream's, time goes on the card.

    python -m goicp_tpu_torch.bench.profile_pair [syn07 trm00 ...]
        [--stream fused|packed] [--out profile.json]

For each named bench pair (similar pool `syn*`, trimmed pool `trm*`, at the
bench's search shape), or with --stream for all named pairs of one pool
together through that cross-pair stream (one shape bucket; fused: width 2;
packed: 16 slots, width 16): one warm-up run, one timed run
(host clock, ending in a device synchronize), and one under torch.profiler
(CPU + CUDA activities), from which it reports the device's busy time (the
sum of kernel times on the single stream), the idle share of the profiled
wall, the kernels by device time, and the host synchronizations the Python
loops pay (stream syncs and device-to-host copies).  Prints one line per
pair; --out also writes the whole summary as JSON.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_registration(run, activities):
    """(result, timed wall s, profile summary dict) of run(), which
    registers on the card."""
    import torch
    from goicp_tpu_torch.bounds import cuda_eval

    sync = torch.cuda.synchronize
    run()                                            # warm-up
    sync()
    t0 = time.perf_counter()
    res = run()
    sync()
    wall = time.perf_counter() - t0
    cuda_eval.reset_launch_counts()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        prof_wall = time.perf_counter() - t0
    launches = cuda_eval.launch_counts()
    events = prof.key_averages()
    kernels = [(e.key, _device_us(e), e.count) for e in events
               if _device_us(e) > 0 and e.device_type is not None
               and str(e.device_type).endswith("CUDA")]
    busy_us = sum(us for _, us, _ in kernels)
    sync_names = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")
    host_syncs = {e.key: e.count for e in events if e.key in sync_names}
    launch_calls = sum(e.count for e in events
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                    "cudaLaunchKernelExC"))
    kernels.sort(key=lambda k: -k[1])
    summary = dict(
        wall_s=wall, profiled_wall_s=prof_wall,
        device_busy_s=busy_us * 1e-6,
        device_idle_share=1.0 - busy_us * 1e-6 / prof_wall,
        kernel_launch_calls=launch_calls, host_sync_calls=host_syncs,
        bound_kernel_launches=launches,
        top_kernels=[dict(name=k[:90], device_ms=us * 1e-3, count=n)
                     for k, us, n in kernels[:10]])
    return res, wall, summary


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("pairs", nargs="*", default=["syn07", "trm00"])
    ap.add_argument("--stream", choices=["fused", "packed"],
                    help="profile the named pairs together through a stream")
    ap.add_argument("--out", help="write the summary to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_pair: no CUDA card", file=sys.stderr)
        return 2
    import goicp_tpu_torch
    from goicp_tpu_torch.bench.measure import (TRIM_FRACTION, bench_shape,
                                               synthetic_pool,
                                               synthetic_pool_trimmed,
                                               _bucket_and_prepare,
                                               _normalized_synthetic)
    from goicp_tpu_torch.search import fused_stream, packed_stream
    from goicp_tpu_torch.search.device_engine import register_device
    from goicp_tpu_torch.pipeline.prepare import (make_count_dynamic,
                                                  prepare_pair)
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = bench_shape(goicp_tpu_torch.GoICPConfig())
    cfg_t = dataclasses.replace(cfg, trimFraction=TRIM_FRACTION,
                                trans_capacity=256)
    pools = {e[0]: e for e in synthetic_pool(64, seed=7)}
    pools.update({e[0]: e for e in synthetic_pool_trimmed(32, seed=23)})
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = dict(card=card, torch=torch.__version__, pairs={})
    if args.stream:
        c = cfg if args.pairs[0].startswith("syn") else cfg_t
        pairs = _bucket_and_prepare(
            [_normalized_synthetic(pools[n]) for n in args.pairs], c,
            device="cuda")
        if args.stream == "fused":
            def run():
                fused_stream.reset_counters()
                return fused_stream.register_fused_stream(
                    pairs, c, width=2, chunk_steps=512)
        else:
            pc = dataclasses.replace(c, packed_slots=16,
                                     packed_trans_every=8)

            def run():
                fused_stream.reset_counters()
                return packed_stream.register_packed_stream(
                    pairs, pc, width=16, chunk_steps=512)
        res, wall, summary = profile_registration(run, acts)
        g = fused_stream.counters["global_iters"]
        summary.update(stream=args.stream, pairs=args.pairs,
                       outer=res.outer_iters.tolist(),
                       inner=res.inner_iters.tolist(),
                       evals=res.evals.tolist(), global_iters=g,
                       host_reads=fused_stream.counters["host_reads"],
                       ms_per_global_iter=1e3 * wall / max(g, 1),
                       launch_calls_per_global_iter=summary[
                           "kernel_launch_calls"] / max(g, 1))
        out["stream"] = summary
        print(args.stream, json.dumps({k: v for k, v in summary.items()
                                       if k != "top_kernels"}), flush=True)
        for k in summary["top_kernels"]:
            print("   ", json.dumps(k), flush=True)
        args.pairs = []
    for name in args.pairs:
        c = cfg if name.startswith("syn") else cfg_t
        data, model, dp, mp = _normalized_synthetic(pools[name])
        pair = make_count_dynamic(prepare_pair(data, model, dp, mp, c,
                                               bucket=True, device="cuda"))
        res, wall, summary = profile_registration(
            lambda: register_device(pair, c), acts)
        summary.update(outer=int(res.outer_iters),
                       inner=int(res.inner_iters), evals=int(res.evals),
                       icp_runs=int(res.icp_runs),
                       ms_per_inner_iter=1e3 * wall / max(
                           int(res.inner_iters), 1))
        out["pairs"][name] = summary
        print(name, json.dumps({k: v for k, v in summary.items()
                                if k != "top_kernels"}), flush=True)
        for k in summary["top_kernels"]:
            print("   ", json.dumps(k), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
