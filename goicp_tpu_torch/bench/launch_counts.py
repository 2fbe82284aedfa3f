"""Kernel launches of the loops the host dispatches, counted on the card
with torch.profiler (every kernel, torch's and the port's, from the
launch API events; host reads from torch's `_local_scalar_dense`, which
every `.item()` and `bool()` of a card tensor goes through):

  * one global iteration of the fused stream: the inner step of a window
    of two live rows on the K3/K4 path (syn03 and syn12, whose searches
    are still live 3 global iterations in);
  * one ICP event: icp_run from four seeds on a bench pair (the outer
    step's icp_seeds) as the engine calls it, at the configuration's
    max_iter and err_diff: its launches, host reads, host-clock ms,
    icp_run's own launch count (csrc/icp.cu) and the rows' iterations;
  * one ICP iteration: the same event with its convergence test switched
    off so that it runs a fixed number of iterations; the launches of 3
    iterations less those of 2 (0 when the event is one launch);
  * one outer transition: device_engine._pop on that pair's first state
    (pop the lowest-lb rotation node, expand its 8 children, the pi-ball
    filter by norm3, rodrigues, the data rotated for every lane);
  * one rescoring: score_transform of that pair at four seeded transforms
    and their nearest-neighbour correspondences (the ICP event's).

    python goicp_tpu_torch/bench/launch_counts.py [--json PATH]

prints one JSON object (the counts, each loop's host-clock ms, the card's
name and power limit).  It uses only functions the port has had since
its cross-pair streams, so the same script counts an older tree's
launches too: put that tree first on PYTHONPATH (its icp_run has no
launch count: null).  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

PAIRS_STEP = ("syn03", "syn12")
PAIR_ICP = "syn07"
ICP_SEEDS = 4


def _bench_pairs(names, device, bucket_together: bool):
    from goicp_tpu_torch.bench.measure import (_bucket_and_prepare,
                                               _normalized_synthetic,
                                               bench_shape, synthetic_pool)
    from goicp_tpu_torch.config import GoICPConfig
    from goicp_tpu_torch.pipeline.prepare import (make_count_dynamic,
                                                  prepare_pair)
    cfg = bench_shape(GoICPConfig())
    pool = {e[0]: e for e in synthetic_pool(64, seed=7)}
    raw = [_normalized_synthetic(pool[n]) for n in names]
    if bucket_together:
        return cfg, _bucket_and_prepare(raw, cfg, device=device)
    return cfg, [make_count_dynamic(prepare_pair(*r, cfg, bucket=True,
                                                 device=device))
                 for r in raw]


def _profile(fn, n: int) -> tuple:
    """(kernel launches, host reads) per call of fn over n profiled
    calls."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    names = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
    events = prof.key_averages()
    return (sum(e.count for e in events if e.key in names) / n,
            sum(e.count for e in events
                if e.key == "aten::_local_scalar_dense") / n)


def _launches(fn, n: int) -> float:
    """Kernel launches per call of fn over n profiled calls."""
    return _profile(fn, n)[0]


def _host_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def global_iteration(device="cuda", n=10) -> dict:
    """Launches and ms of the fused stream's inner step, two live rows."""
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.search import fused_stream as fs
    cfg, pairs = _bench_pairs(PAIRS_STEP, device, bucket_together=True)
    pb = stack_pairs(pairs)
    state = fs.fused_run_chunk(pb, cfg, fs._init_batch(pb, cfg), 3)
    live = ~state["converged"] & ~fs._inner_complete(cfg, state)
    if not bool(live.all()):
        raise RuntimeError("both rows live 3 global iterations in")
    tables = fs._window_tables(pb, cfg, state["inner"]["done"].shape[1])

    def step():
        return fs._inner_step(pb, cfg, state, tables, live)
    return dict(launches=_launches(step, n), ms=_host_ms(step, 5 * n))


def _icp_event_fn(device):
    """(cfg, event): event(max_iter, err_diff) is a thunk running icp_run
    from ICP_SEEDS seeds near the identity on PAIR_ICP's padded bucket."""
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    from goicp_tpu_torch.icp.icp import icp_run
    cfg, (pair,) = _bench_pairs((PAIR_ICP,), device, bucket_together=False)
    rng = np.random.default_rng(7)
    R0 = torch.as_tensor(np.stack([rodrigues_np(v) for v in rng.uniform(
        -0.3, 0.3, (ICP_SEEDS, 3))]), dtype=torch.float32, device=device)
    t0 = torch.zeros((ICP_SEEDS, 3), device=device)

    def event(iters, err_diff):
        return lambda: icp_run(
            pair.data, pair.model, R0, t0, inlier_num=pair.inlier_num,
            max_iter=iters, err_diff=err_diff,
            data_mask=pair.data_mask, count=pair.inlier_f(),
            dynamic_trim=pair.dynamic_counts and cfg.doTrim)
    return cfg, event


def icp_iteration(device="cuda", n=3) -> dict:
    """Launches and ms of one ICP iteration of an event from ICP_SEEDS
    seeds, the difference of a 3- and a 2-iteration event (err_diff -inf:
    no row converges, every row runs max_iter)."""
    _, event = _icp_event_fn(device)
    e3, e2 = event(3, -float("inf")), event(2, -float("inf"))
    return dict(launches=_launches(e3, n) - _launches(e2, n),
                ms=_host_ms(e3, n) - _host_ms(e2, n))


def icp_event(device="cuda", n=3) -> dict:
    """Launches, host reads and ms of one ICP event as the engine runs it
    (the configuration's max_iter and err_diff), icp_run's own launches
    per event and the rows' iterations."""
    from goicp_tpu_torch.icp import icp
    cfg, event = _icp_event_fn(device)
    fn = event(cfg.icp_max_iter, cfg.err_diff)
    counter = getattr(icp.icp_run, "launches", None)
    launches, reads = _profile(fn, n)
    own = (None if counter is None
           else (icp.icp_run.launches - counter) / n)
    return dict(launches=launches, host_reads=reads, icp_run_launches=own,
                iterations=fn().iters.tolist(), ms=_host_ms(fn, n))


def transition(device="cuda", n=10) -> dict:
    """Launches and ms of one outer transition (device_engine._pop)."""
    from goicp_tpu_torch.search import device_engine as eng
    cfg, (pair,) = _bench_pairs((PAIR_ICP,), device, bucket_together=False)
    state = eng.device_init(pair, cfg)

    def step():
        return eng._pop(pair, cfg, state)
    return dict(launches=_launches(step, n), ms=_host_ms(step, 5 * n))


def rescoring(device="cuda", n=10) -> dict:
    """Launches and ms of one score_transform at ICP_SEEDS transforms."""
    from goicp_tpu_torch.bounds.error import score_transform
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    from goicp_tpu_torch.icp.icp import nn_correspondences
    cfg, (pair,) = _bench_pairs((PAIR_ICP,), device, bucket_together=False)
    rng = np.random.default_rng(9)
    R = torch.as_tensor(np.stack([rodrigues_np(v) for v in rng.uniform(
        -0.3, 0.3, (ICP_SEEDS, 3))]), dtype=torch.float32, device=device)
    t = torch.as_tensor(rng.uniform(-0.05, 0.05, (ICP_SEEDS, 3)),
                        dtype=torch.float32, device=device)
    pts = torch.einsum("kij,nj->kni", R, pair.data) + t[:, None, :]
    nn_idx, _ = nn_correspondences(pts, pair.model)

    def score():
        return score_transform(pair, cfg, R, t, nn_idx)
    return dict(launches=_launches(score, n), ms=_host_ms(score, 5 * n))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the object to this file")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_counts needs a CUDA device", file=sys.stderr)
        return 1
    import goicp_tpu_torch
    out = dict(package=goicp_tpu_torch.__file__, card=card(),
               global_iteration=global_iteration(),
               icp_iteration=icp_iteration(), icp_event=icp_event(),
               transition=transition(), rescoring=rescoring())
    print(json.dumps(out), flush=True)
    if a.json:
        with open(a.json, "w") as fh:
            json.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
