"""Where an ICP event's time goes on the card: the ICP kernel (csrc/icp.cu,
goicp_icp_run) built with stop points compiled in and each variant timed
from a CUDA graph.

    python -m goicp_tpu_torch.bench.icp_stops [--json PATH]
        [--stops 1,2,3,4] [--events 0,1,2,6] [--csrc DIR]

A variant is csrc/icp.cu built with -DGOICP_ICP_STOP=n (_build.variant:
a library of its own, named by the hash of its sources and flags; the
variants build at once, one nvcc each, with ptxas's registers, stack
frame and spills printed for the ICP kernel): every iteration ends after
stage n, in the order of icp.cu's list (1 the rotation and the nearest
neighbours, 2 the mask, 3 the 7 masked sums, 4 H's 9 sums; the full
kernel adds 5, the convergence test, the Kabsch and the update), and
every enabled row runs as many iterations as the full event's longest
row.  The difference between two successive rows is what that stage adds
to an iteration.  --csrc DIR (any number of times) adds the full kernel
of another copy of csrc/ (the goicp_icp_run interface unchanged: an
older tree's kernel, or a change to try); those and the tree's own are
timed in turns (each other kernel, the tree's, the tree's again, each
other again, reversed), so that a drift
of the card's clocks weighs on all, and each one's result is held to the
tree's kernel's bit for bit.  Last, one Kabsch's latency: kabsch3 on one
H from a graph, beside an empty kernel's.

The events (icp_events; chip_smoke.py phase 2 runs the same ones): 0
syn07's 4-seed untrimmed event, 1 syn07's padded bucket (data_mask and
count, row 1 disabled), 2 trm00 with count and dynamic_trim, 3 trm00 with
a static trim, 4 the demo's 1000 / 500 points, 5 4,200 / 4,200 points
(the workspace in device memory), 6 syn07's padded bucket as the fused
stream refines a row (K = 1), 7 the same from the 8 initial seeds (K =
8), 8 165 / 306 points with a static trim and 9 306 / 306 untrimmed (the
bench's smallest and largest clouds).  Each full kernel's time is also
taken as single calls (the median of 25 between CUDA events, the host's
enqueue included).  Prints one line a variant, the card's name and power
limit, and the JSON (also to --json).  Needs a card.  Run from an older
tree's root (it needs this module, bench/probe.py and _build.variant's
logs), it times that tree's kernel and its stop points.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import sys
import time

from goicp_tpu_torch.bench.probe import card, device_ms, median_ms, setup

STAGES = {1: "rotation, nearest neighbours", 2: "mask (rank)",
          3: "7 masked sums", 4: "H's 9 sums",
          5: "convergence, Kabsch, update (the full kernel)"}
DEMO_POINTS = (1000, 500)           # model and data points
BIG_POINTS, BIG_ITERS = 4200, 8     # the event whose workspace is global
EVENTS_DEFAULT = "0,1,2,6"


def _prepared(name, cfg, pools, dev):
    from goicp_tpu_torch.bench.measure import _normalized_synthetic
    from goicp_tpu_torch.pipeline.prepare import (make_count_dynamic,
                                                  prepare_pair)
    return make_count_dynamic(prepare_pair(
        *_normalized_synthetic(pools[name]), cfg, bucket=True, device=dev))


def engine_kw(pair, cfg) -> dict:
    """icp_run's keywords as the engine passes them (device_engine.
    _icp_from)."""
    return dict(inlier_num=pair.inlier_num, max_iter=cfg.icp_max_iter,
                err_diff=cfg.err_diff,
                data_mask=pair.data_mask if pair.padded else None,
                count=pair.inlier_f() if pair.dynamic_counts else None,
                dynamic_trim=pair.dynamic_counts and cfg.doTrim)


def icp_events(cfg, cfg_t, pools, dev) -> list:
    """[(label, data, model, R0, t0, icp_run keywords)]: the events of the
    module docstring, from numpy seeds (the first six as chip_smoke.py
    phase 2 has drawn them since the ICP kernel was written)."""
    import numpy as np
    import torch
    from goicp_tpu_torch.bench.measure import _normalized_synthetic
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    from goicp_tpu_torch.pipeline.prepare import prepare_pair
    from goicp_tpu_torch.search.device_engine import _INIT_SEED_RV
    rng = np.random.default_rng(13)
    K = cfg.icp_seeds
    f32 = dict(dtype=torch.float32, device=dev)

    def starts(k):
        R0 = torch.as_tensor(np.stack([rodrigues_np(v) for v in rng.uniform(
            -0.3, 0.3, (k, 3))]), **f32)
        t0 = torch.as_tensor(rng.uniform(-0.05, 0.05, (k, 3)), **f32)
        return R0, t0

    def cloud(nm, nd):
        model = rng.uniform(-0.7, 0.7, (nm, 3))
        data = (model[:nd] - rng.uniform(-0.1, 0.1, 3)) @ rodrigues_np(
            rng.uniform(-0.3, 0.3, 3))
        return torch.as_tensor(data, **f32), torch.as_tensor(model, **f32)

    syn07 = _prepared("syn07", cfg, pools, dev)
    real07 = syn07.data[syn07.data_mask > 0].contiguous()
    trm00 = _prepared("trm00", cfg_t, pools, dev)
    static00 = prepare_pair(*_normalized_synthetic(pools["trm00"]), cfg_t,
                            bucket=True, device=dev)
    demo_model = rng.uniform(-0.7, 0.7, (DEMO_POINTS[0], 3))
    demo_data = (demo_model[:DEMO_POINTS[1]] - rng.uniform(-0.1, 0.1, 3)) \
        @ rodrigues_np(rng.uniform(-0.3, 0.3, 3))
    big = rng.uniform(-0.7, 0.7, (BIG_POINTS, 3))
    big_data = (big - 0.01) @ rodrigues_np(np.array([0.02, -0.01, 0.03]))
    R4, t4 = starts(K)
    events = [
        ("syn07, 4 seeds, untrimmed", real07, syn07.model, R4, t4,
         dict(inlier_num=real07.shape[0], max_iter=cfg.icp_max_iter,
              err_diff=cfg.err_diff)),
        ("syn07 padded bucket (data_mask, count), row 1 disabled",
         syn07.data, syn07.model, *starts(K),
         dict(engine_kw(syn07, cfg), enabled=torch.tensor(
             [True, False, True, True][:K], device=dev))),
        ("trm00 count + dynamic_trim", trm00.data, trm00.model, *starts(K),
         engine_kw(trm00, cfg_t)),
        ("trm00 static trim", static00.data, static00.model, *starts(K),
         engine_kw(static00, cfg_t)),
        (f"demo {DEMO_POINTS[0]} / {DEMO_POINTS[1]} points",
         torch.as_tensor(demo_data, **f32), torch.as_tensor(demo_model, **f32),
         *starts(K), dict(inlier_num=DEMO_POINTS[1], max_iter=cfg.icp_max_iter,
                          err_diff=cfg.err_diff)),
        (f"{BIG_POINTS} / {BIG_POINTS} points, workspace in device memory",
         torch.as_tensor(big_data, **f32), torch.as_tensor(big, **f32),
         *starts(1), dict(inlier_num=BIG_POINTS, max_iter=BIG_ITERS,
                          err_diff=cfg.err_diff)),
    ]
    # the fused stream's refinement: one row (K = 1); the initial seeds
    R8 = torch.as_tensor(np.stack([rodrigues_np(v) for v in _INIT_SEED_RV]),
                         **f32)
    t8 = torch.as_tensor(rng.uniform(-0.05, 0.05, (8, 3)), **f32)
    events += [
        ("syn07 padded bucket, K = 1 (a fused-stream row)", syn07.data,
         syn07.model, *starts(1), engine_kw(syn07, cfg)),
        ("syn07 padded bucket, K = 8 (the initial seeds)", syn07.data,
         syn07.model, R8, t8, engine_kw(syn07, cfg)),
    ]
    d165, m306 = cloud(306, 165)
    d306, m306b = cloud(306, 306)
    events += [
        ("165 / 306 points, static trim", d165, m306, *starts(K),
         dict(inlier_num=149, max_iter=cfg.icp_max_iter,
              err_diff=cfg.err_diff)),
        ("306 / 306 points, untrimmed", d306, m306b, *starts(K),
         dict(inlier_num=306, max_iter=cfg.icp_max_iter,
              err_diff=cfg.err_diff)),
    ]
    return events


def kernel_info(log: str, name: str = "icp_run_kernel") -> list:
    """ptxas's lines for the entry functions whose name holds `name`
    (registers, stack frame, spills), from a `-Xptxas -v` log."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = name in line
            if keep:
                out.append(re.sub(r".*entry function '([^']*)'.*", r"\1",
                                  line))
        elif keep and ("registers" in line or "stack frame" in line):
            out.append(line.strip().replace("ptxas info    : ", ""))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--stops", default="1,2,3,4")
    ap.add_argument("--events", default=EVENTS_DEFAULT,
                    help="indices of icp_events, or 'all'")
    ap.add_argument("--csrc", action="append", default=[])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("icp_stops: needs a CUDA card", file=sys.stderr)
        return 2
    import pathlib

    from goicp_tpu_torch import _build
    from goicp_tpu_torch.icp import icp as ticp
    from goicp_tpu_torch.utils.fp32 import kernels

    stops = [int(x) for x in args.stops.split(",") if x]
    # a build: (name, source directory, defines, stem)
    builds = [(f"stop {n}", _build.CSRC, (f"GOICP_ICP_STOP={n}",),
               f"libgoicp_icp_stop{n}") for n in stops]
    builds += [(f"full {d}", d, (), f"libgoicp_icp_full{i}")
               for i, d in enumerate([_build.CSRC] + [
                   pathlib.Path(d).resolve() for d in args.csrc])]
    logs = {}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as ex:
        libs = list(ex.map(lambda b: _build.variant(
            ("icp.cu",), b[2], b[1], stem=b[3], logs=logs), builds))
    build_s = time.perf_counter() - t0
    names = [b[0] for b in builds]
    ptxas = {}
    for name, (_, _, _, stem) in zip(names, builds):
        ptxas[name] = kernel_info(logs[stem])
        print(f"icp_stops ptxas, {name}: {ptxas[name]}", flush=True)
    by_name = dict(zip(names, libs))
    fulls = names[len(stops):]          # the tree's first, then each --csrc

    dev = torch.device("cuda")
    cfg, cfg_t, pools = setup()
    events = icp_events(cfg, cfg_t, pools, dev)
    pick = range(len(events)) if args.events == "all" else [
        int(x) for x in args.events.split(",") if x]
    report = dict(card=card(), torch=torch.__version__,
                  build_s=round(build_s, 1), ptxas=ptxas, events={})

    def timed(lib, fn, single=False):
        ticp.kernels = lib
        try:
            return median_ms(fn) if single else device_ms(fn)
        finally:
            ticp.kernels = kernels

    for e in pick:
        label, data, model, R0, t0_, kw = events[e]
        full = ticp.icp_run(data, model, R0, t0_, **kw)
        iters = full.iters.tolist()
        n_it = max(max(iters), 1)
        rows = []
        prev = 0.0
        for n, name in zip(stops, names):
            kw_n = dict(kw, max_iter=n_it)
            ms = timed(by_name[name], lambda: ticp.icp_run(
                data, model, R0, t0_, **kw_n))
            us = ms / n_it * 1e3
            rows.append(dict(stop=n, stage=STAGES[n], graph_ms=ms,
                             us_per_iteration=us, delta_us=us - prev))
            print(f"icp_stops [{e}] {label}: stop {n} ({STAGES[n]}): "
                  f"{ms:.4f} ms, {us:.3f} us an iteration "
                  f"(+{us - prev:.3f})", flush=True)
            prev = us
        # every other full kernel's result, bit for bit the tree's
        same = {}
        for name in fulls[1:]:
            ticp.kernels = by_name[name]
            try:
                other = ticp.icp_run(data, model, R0, t0_, **kw)
            finally:
                ticp.kernels = kernels
            same[name] = all(torch.equal(
                getattr(other, f).view(torch.int32) if
                getattr(other, f).dtype == torch.float32 else
                getattr(other, f), getattr(full, f).view(torch.int32) if
                getattr(full, f).dtype == torch.float32 else getattr(full, f))
                for f in full._fields)
        # the full kernels in turns: others..., tree, tree, ...others
        order = fulls[1:] + fulls[:1] + fulls[:1] + fulls[1:][::-1]
        got = {name: [] for name in fulls}
        for name in order:
            got[name].append((
                timed(by_name[name], lambda: ticp.icp_run(
                    data, model, R0, t0_, **kw)),
                timed(by_name[name], lambda: ticp.icp_run(
                    data, model, R0, t0_, **kw), single=True)))
        for i, name in enumerate(fulls):
            g = [x[0] for x in got[name]]
            s_ = [x[1] for x in got[name]]
            us = sum(g) / len(g) / n_it * 1e3
            rows.append(dict(stop=5, stage=STAGES[5] if i == 0 else name,
                             kernel=name, graph_ms_turns=g, ms_turns=s_,
                             us_per_iteration=us,
                             delta_us=us - prev if i == 0 else None,
                             same_bits=same.get(name)))
            print(f"icp_stops [{e}] {label}: {name}: graph_ms "
                  f"{' / '.join(f'{x:.4f}' for x in g)}, {us:.3f} us an "
                  f"iteration{f' (+{us - prev:.3f})' if i == 0 else ''}; "
                  f"single calls {' / '.join(f'{x:.4f}' for x in s_)} ms"
                  f"{'' if i == 0 else f'; the same bits: {same[name]}'}",
                  flush=True)
        report["events"][label] = dict(
            index=e, nd=int(data.shape[0]), m=int(model.shape[0]),
            K=int(R0.shape[0]), iters=iters, rows=rows)
    # one Kabsch's latency: kabsch3 on one H (a syn07-like correlation of
    # 167 points) against an empty kernel, both from a graph
    import numpy as np
    from goicp_tpu_torch.bounds.cuda_eval import empty_launch
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    rng = np.random.default_rng(17)
    q_d = rng.normal(size=(167, 3))
    H1 = torch.as_tensor(q_d.T @ (q_d @ rodrigues_np(np.array(
        [0.3, -0.2, 0.1])).T), dtype=torch.float32, device=dev)[None]
    k_ms = device_ms(lambda: ticp.kabsch3(H1), n=50)
    e_ms = device_ms(lambda: empty_launch(dev), n=50)
    report["kabsch3_one_ms"], report["empty_ms"] = k_ms, e_ms
    print(f"icp_stops kabsch3 of one H {k_ms:.4f} ms a launch, an empty "
          f"kernel {e_ms:.4f} ms: one Kabsch ~{(k_ms - e_ms) * 1e3:.3f} us",
          flush=True)
    print(report["card"])
    line = json.dumps(report)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
