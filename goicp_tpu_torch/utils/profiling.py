"""Profiling / tracing utilities.

Port of goicp_tpu/utils/profiling.py.  The reference's only
instrumentation is clock() prints (jly_main.cpp:108-123,
jly_goicp.cpp:694-700).  Here:
  * `PhaseTimers` — named phase timing accumulated in a dict;
  * `trace` — torch.profiler over a block (CPU and, on a card, CUDA
    activity), written to `log_dir` as a Chrome trace
    (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class PhaseTimers:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 4), "calls": self.counts[k]}
                for k, v in sorted(self.totals.items(),
                                   key=lambda kv: -kv[1])}


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace of the block, written to
    log_dir/trace_<pid>_<time>.json when log_dir is given; no-op otherwise.
    Yields the profiler (None without log_dir)."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
