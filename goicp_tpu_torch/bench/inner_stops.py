"""Where an inner-run iteration's time goes on the card: the run kernel
(csrc/inner.cu, goicp_inner_run) built with stop points compiled in and
each variant timed from a CUDA graph.

    python -m goicp_tpu_torch.bench.inner_stops [--json PATH]
        [--stops 1,2,3,4,5,6,7,8] [--warm 3] [--csrc DIR]

A variant is csrc/inner.cu built with -DGOICP_INNER_STOP=n (_build.variant:
a library of its own, named by the hash of its sources and flags; the
variants build at once, one nvcc each): every iteration ends after stage
n of the lane body, in the order of inner_body.cuh's list (1 the done
check and the pop, 2 the children and corners, 3 the bodies' staging, 4
the geometric body, 5 the chem body, 6 the gather, 7 the chem terms and
the adoption, 8 the merge), with what it computed left in shared or
device memory, and the run iterates with no agreement between clusters
as many times as the full run made iterations.  Every run starts from
the lanes' state after --warm full iterations (default 3): the frontiers
full, so that each pop expands its P parents as mid-search iterations
do; a variant stopped before the merge iterates on that state unchanged.
The full kernel (the normal build, no stop) is timed the same way; the
difference between two successive rows is what that stage adds to an
iteration's dependent chain.  A stop variant's lanes never finish, so it
does every iteration's full work where the full run's finished lanes
idle: its rows may sum past the full run's.  --csrc DIR (any number of
times) adds a full kernel built from another copy of csrc/: changes to
try beside the tree's own kernel in one call.

Three shapes, each from inner.initial_lanes with about a fifth of the
lanes done (chip_smoke.py phase 2's inputs): "search", syn07's whole
inner search, 8 lanes (register_device's shape); "stream", syn00 + syn01
in 16 interleaved lanes of two groups, mode stream up to 40 iterations
(the streams' shape); "stride", syn00-syn15 in 128 lanes of 16 groups,
mode stream up to 40 iterations (launch_counts.py's 512-step chunk: more
lanes than the card holds clusters, so they stride).  Each shape's full run is also timed as single calls
(the median of 25 between CUDA events, the host's enqueue included):
with a run's TransitionBuffers kept across the calls, where the tree's
inner_run takes them (ms_bufs), and without (ms_per_call); ms_bufs less
the full kernel's graph_ms is the call's host share.  Prints one line a
variant, the card's name and power limit, and the JSON (also to
--json).  Needs a card; with an older tree
first on PYTHONPATH it times that tree's kernel and its stop points.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import sys
import time

from goicp_tpu_torch.bench.probe import card, device_ms, median_ms, setup

STAGES = {1: "done check, pop", 2: "children, corners", 3: "staging",
          4: "geometric body", 5: "chem body", 6: "gather",
          7: "chem terms, adoption", 8: "merge", 99: "full run"}
STREAM_STEPS = 40
WARM = 3               # full iterations before the timed runs


def _lanes(names, cfg, pools, dev, rng, lanes=8):
    """(tables or pair, points, rotation uncertainty, initial lanes,
    groups): chip_smoke.py's _step_inputs and _step_root."""
    import numpy as np
    import torch
    from goicp_tpu_torch.bench.measure import (_bucket_and_prepare,
                                               _normalized_synthetic)
    from goicp_tpu_torch.bounds.evaluate import lane_tables, rot_uncertainty
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    from goicp_tpu_torch.pipeline.prepare import (make_count_dynamic,
                                                  prepare_pair)
    from goicp_tpu_torch.search import inner
    if isinstance(names, str):
        pairs = [make_count_dynamic(prepare_pair(
            *_normalized_synthetic(pools[names]), cfg, bucket=True,
            device=dev))]
        lane_pair = [0] * lanes
    else:
        pairs = _bucket_and_prepare([_normalized_synthetic(pools[n])
                                     for n in names], cfg, device=dev)
        lane_pair = [0, 1, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0] \
            if len(pairs) == 2 else [w for w in range(len(pairs))
                                     for _ in range(lanes)]
    L = len(lane_pair)
    rots = np.stack([rodrigues_np(v) for v in rng.uniform(-2.5, 2.5,
                                                          (L, 3))])
    pts = torch.stack([
        torch.as_tensor(rots[l], dtype=torch.float32, device=dev)
        @ pairs[w].data.T for l, w in enumerate(lane_pair)]).transpose(1, 2)
    pts = pts.contiguous()
    widths = torch.as_tensor(rng.uniform(0.05, 0.6, L), dtype=torch.float32,
                             device=dev)
    active = torch.as_tensor(rng.uniform(size=L) < 0.8, device=dev)
    active[0] = True
    mrd = torch.cat([rot_uncertainty(widths[l:l + 1], pairs[w].norm_data)
                     for l, w in enumerate(lane_pair)])
    s = inner.initial_lanes(pairs[0], cfg, pts, active,
                            torch.tensor(1e4, device=dev))
    for w, pair in enumerate(pairs[1:], 1):
        sel = torch.tensor([l for l, p in enumerate(lane_pair) if p == w],
                           device=dev)
        if "cvals" in s:
            s["cvals"][sel, 0] = inner.root_corner_values(pair, cfg,
                                                          pts[sel])
    if len(pairs) == 1:
        return pairs[0], pts, mrd, s, 1
    tables = lane_tables(stack_pairs(pairs), cfg, torch.as_tensor(
        lane_pair, dtype=torch.int32, device=dev))
    return tables, pts, mrd, s, len(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--stops", default="1,2,3,4,5,6,7,8")
    ap.add_argument("--warm", type=int, default=WARM)
    ap.add_argument("--csrc", action="append", default=[])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("inner_stops: needs a CUDA card", file=sys.stderr)
        return 2
    import inspect
    import pathlib

    import numpy as np

    from goicp_tpu_torch import _build
    from goicp_tpu_torch.search import inner
    from goicp_tpu_torch.utils.fp32 import kernels

    try:
        from goicp_tpu_torch.search.args import TransitionBuffers as buffers
    except ImportError:         # an older tree keeps them in transition.py
        from goicp_tpu_torch.search.transition import \
            TransitionBuffers as buffers
    stops = [int(x) for x in args.stops.split(",") if x]
    # a build: (stop, source directory); stop 0 the full kernel
    builds = [(n, _build.CSRC) for n in stops] + [
        (0, pathlib.Path(d).resolve()) for d in args.csrc]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds) or 1) as ex:
        libs = list(ex.map(lambda b: _build.variant(
            ("inner.cu",), (f"GOICP_INNER_STOP={b[0]}",) if b[0] else (),
            b[1], stem=f"libgoicp_inner_{b[0]}_{b[1].name}"), builds))
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    cfg, _, pools = setup()
    rng = np.random.default_rng(2028)
    shapes = {"search": _lanes("syn07", cfg, pools, dev, rng),
              "stream": _lanes(("syn00", "syn01"), cfg, pools, dev, rng),
              "stride": _lanes(tuple(f"syn{i:02d}" for i in range(16)),
                               cfg, pools, dev, rng)}
    report = dict(card=card(), torch=torch.__version__, warm=args.warm,
                  build_s=round(build_s, 1), shapes={})
    for name, (pair, pts, mrd, s, groups) in shapes.items():
        mode = "search" if name == "search" else "stream"
        kw = dict(groups=groups, steps=STREAM_STEPS) if mode == "stream" \
            else {}
        # mid-search state: the frontiers full, every pop expanding
        warm = inner.inner_run(
            pair, dataclasses.replace(cfg, inner_max_iters=args.warm), s,
            pts, mrd, True, "search")
        s = {k: v.clone() for k, v in warm.lanes.items()}
        full = inner.inner_run(pair, cfg, s, pts, mrd, True, mode, **kw)
        n_it = int(full.iters)
        rows = []
        for (n, src), lib in list(zip(builds, libs)) + [((99, None), None)]:
            c, kw_n = cfg, kw
            if n != 99:
                c = dataclasses.replace(cfg, inner_max_iters=n_it)
                kw_n = dict(kw, steps=n_it) if mode == "stream" else kw
            if lib is not None:
                inner.kernels = lib
            try:
                ms = device_ms(lambda: inner.inner_run(
                    pair, c, s, pts, mrd, True, mode, **kw_n))
            finally:
                inner.kernels = kernels
            stage = STAGES[n] if n else f"full run ({src})"
            rows.append(dict(stop=n, stage=stage, graph_ms=ms,
                             per_iteration_ms=ms / max(n_it, 1)))
            prev = rows[-2]["per_iteration_ms"] if len(rows) > 1 else 0.0
            print(f"inner_stops {name}: stop {n} ({stage}): {ms:.4f} ms "
                  f"a run of {n_it} iterations, "
                  f"{ms / max(n_it, 1):.5f} ms an iteration "
                  f"(+{ms / max(n_it, 1) - prev:.5f})", flush=True)
        def call(**kw_c):
            return inner.inner_run(pair, cfg, s, pts, mrd, True, mode,
                                   **kw, **kw_c)
        has = "bufs" in inspect.signature(inner.inner_run).parameters
        bufs = buffers() if has else None
        ms_bufs = median_ms(lambda: call(bufs=bufs)) if has else None
        ms_call = median_ms(call)
        full_ms = rows[-1]["graph_ms"]
        print(f"inner_stops {name}: single calls {ms_bufs} ms with the "
              f"run's buffers (host share "
              f"{None if ms_bufs is None else ms_bufs - full_ms}), "
              f"{ms_call:.4f} ms without", flush=True)
        report["shapes"][name] = dict(
            lanes=int(pts.shape[0]), iterations=n_it, ms_bufs=ms_bufs,
            ms_per_call=ms_call,
            host_share_ms=None if ms_bufs is None else ms_bufs - full_ms,
            clusters=None if full.clusters is None else int(full.clusters),
            resident=None if getattr(full, "resident", None) is None
            else int(full.resident), stops=rows)
    print(report["card"])
    line = json.dumps(report)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
