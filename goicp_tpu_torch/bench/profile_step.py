"""Where a fused-stream global iteration's host time goes on the card.

    python -m goicp_tpu_torch.bench.profile_step [syn03 syn12 syn07 ...]
        [--out profile_step.json]

The named pairs of the similar pool (bench search shape, one shape bucket)
run through register_fused_stream(width=2, chunk_steps=512) twice: once
untouched (the wall), once with the stream's three phases wrapped in
timers that synchronize the device before and after (the inner step of
every global iteration; the transition events; inside them the ICP refine
block), which gives each phase's calls, seconds and ms per call.  Then, on
a mid-search window state, the mean over 200 calls (one synchronize at
the end) and the launches per call (torch.profiler over 20
calls) of: the stream's inner step (one launch of csrc/inner.cu), the
torch inner body alone (inner_step_plain's, off the main path on the card)
on the window's W*L lanes (per-lane tables, K3/K4), and the same body on
one pair's L lanes (K1/K2), each also with the one host read its loop
pays per iteration.  register_device's wall on each pair stands beside the stream's.
Prints one JSON object.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _timed(fn, acc, sync):
    def wrapper(*a, **k):
        sync()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        sync()
        acc["s"] += time.perf_counter() - t0
        acc["calls"] += 1
        return out
    return wrapper


def _mean_ms(fn, sync, n=200):
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter() - t0) / n * 1e3


def _calls_per_run(fn, sync, n=20):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        sync()
    names = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
             "cudaMemcpyAsync", "cudaStreamSynchronize")
    return {e.key: e.count / n for e in prof.key_averages()
            if e.key in names}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("pairs", nargs="*", default=["syn03", "syn12", "syn07"])
    ap.add_argument("--out", help="write the summary to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA card", file=sys.stderr)
        return 2
    import goicp_tpu_torch
    from goicp_tpu_torch.bench.measure import (_bucket_and_prepare,
                                               _normalized_synthetic,
                                               bench_shape, synthetic_pool)
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.search import fused_stream as fs
    from goicp_tpu_torch.search import inner
    from goicp_tpu_torch.search.device_engine import register_device

    sync = torch.cuda.synchronize
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = bench_shape(goicp_tpu_torch.GoICPConfig())
    pools = {e[0]: e for e in synthetic_pool(64, seed=7)}
    pairs = _bucket_and_prepare(
        [_normalized_synthetic(pools[n]) for n in args.pairs], cfg,
        device="cuda")
    out = dict(card=card, torch=torch.__version__, pairs=args.pairs)

    def stream():
        fs.reset_counters()
        res = fs.register_fused_stream(pairs, cfg, width=2, chunk_steps=512)
        sync()
        return res

    # ---- the stream's wall, then its phases under timers ----
    stream()                                             # warm-up
    t0 = time.perf_counter()
    res = stream()
    out.update(wall_s=time.perf_counter() - t0, counters=dict(fs.counters),
               icp_runs=res.icp_runs.tolist(),
               outer=res.outer_iters.tolist(),
               inner=res.inner_iters.tolist())
    one_by_one = []
    for pair in pairs:
        t0 = time.perf_counter()
        register_device(pair, cfg)
        sync()
        one_by_one.append(time.perf_counter() - t0)
    out["register_device_wall_s"] = one_by_one
    phases = {k: dict(s=0.0, calls=0)
              for k in ("_inner_step", "_transition_batch", "_refine")}
    plain = {k: getattr(fs, k) for k in phases}
    try:
        for k in phases:
            setattr(fs, k, _timed(plain[k], phases[k], sync))
        t0 = time.perf_counter()
        stream()
        out["timed_wall_s"] = time.perf_counter() - t0
    finally:
        for k in phases:
            setattr(fs, k, plain[k])
    for k, p in phases.items():
        p["ms_per_call"] = 1e3 * p["s"] / max(p["calls"], 1)
    out["phases"] = phases
    out["other_s"] = out["timed_wall_s"] - phases["_inner_step"]["s"] \
        - phases["_transition_batch"]["s"]

    # ---- one iteration's pieces on a mid-search window state ----
    pb = stack_pairs(pairs[:2])
    state = fs.fused_run_chunk(pb, cfg, fs._init_batch(pb, cfg), 60)
    W, L = state["inner"]["done"].shape
    tables = fs._window_tables(pb, cfg, L)
    live = ~state["converged"] & ~fs._inner_complete(cfg, state)
    ist = state["inner"]
    lanes = {k: ist[k].reshape((W * L,) + ist[k].shape[2:])
             for k in inner._PER_LANE if k in ist}
    pts = state["pts_rot"].reshape(W * L, -1, 3)
    mrd = state["mrd"].reshape(W * L, -1)
    body = inner._make_inner_body(
        tables, cfg, pts, mrd, tables.sse[tables.lane_pair.long()],
        fused=True)
    p0 = fs._pair_row(pb, 0)
    sse0 = torch.tensor(cfg.mse_margin, device="cuda") * p0.inlier_f()
    lanes0 = {k: ist[k][0] for k in lanes}
    body0 = inner._make_inner_body(p0, cfg, state["pts_rot"][0],
                                   state["mrd"][0], sse0, fused=True)

    def step():
        return fs._inner_step(pb, cfg, state, tables, live)

    def step_read():
        step()
        torch.stack([state["converged"], state["converged"],
                     fs._inner_complete(cfg, state)]).cpu()

    def body0_read():
        int(torch.sum(~body0(lanes0)[0]["done"]))

    cases = {"inner_step": step, "inner_step_and_read": step_read,
             "body_window_lanes": lambda: body(lanes),
             "body_one_pair": lambda: body0(lanes0),
             "body_one_pair_and_read": body0_read}
    out["live_rows"] = live.tolist()
    out["per_call"] = {k: dict(ms=_mean_ms(fn, sync),
                               **_calls_per_run(fn, sync))
                       for k, fn in cases.items()}
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
