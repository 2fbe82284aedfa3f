"""What the stage probes (bench/inner_stops.py, bench/icp_stops.py) share:
the two timers, the card's name and power limit, and the bench's
configuration and synthetic pools."""

from __future__ import annotations

import statistics
import subprocess
import time


def device_ms(fn, n=10, reps=7, warm_s=0.03):
    """Per-call time of fn from n calls captured into one CUDA graph, the
    median of reps replays between CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        graph.replay()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def median_ms(fn, n=25):
    """The median of n single calls of fn between CUDA events."""
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


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def setup():
    """(cfg, cfg_t, pools): GoICPConfig() + bench_shape, its trimmed form,
    and the bench's synthetic pools by name (chip_smoke.py's)."""
    import dataclasses

    import goicp_tpu_torch
    from goicp_tpu_torch.bench.measure import (TRIM_FRACTION, bench_shape,
                                               synthetic_pool,
                                               synthetic_pool_trimmed)
    cfg = bench_shape(goicp_tpu_torch.GoICPConfig())
    cfg_t = dataclasses.replace(cfg, trimFraction=TRIM_FRACTION,
                                trans_capacity=256)
    pools = {e[0]: e for e in synthetic_pool(64, seed=7)}
    pools.update({e[0]: e for e in synthetic_pool_trimmed(32, seed=23)})
    return cfg, cfg_t, pools
