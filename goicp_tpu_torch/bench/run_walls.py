"""Host-clock walls of the inner run's callers, for the tree that comes
first on PYTHONPATH (as launch_counts.py), so that two trees can be
timed in turns in one call:

    PYTHONPATH=TREE python goicp_tpu_torch/bench/run_walls.py [--reps N]
        [--json PATH] [--only WORD ...]

  bench: chip_smoke.py phase 8's passes, the fused stream over 16
    similar pairs in at most 4 buckets and over 8 trimmed pairs
    (measure.timed_pass, held to its parity check): pairs/s;
  batch: phase 9's compacting batch (chunked.
    register_device_batch_compact, chunk_steps 256, pad_to 8) on its six
    similar and four trimmed pairs: s;
  chunk: launch_counts.stream_chunk, one fused_run_chunk of 512 global
    iterations over syn00-syn15 (128 lanes in mode stream): ms;
  fused: chip_smoke.py phase 5's streams, register_fused_stream (width 2,
    chunk_steps 512) over syn00-syn15 and over trm00-trm07, each pool in
    one bucket, prepared before the clock starts: s;
  syn72: chip_smoke.py phase 13's registration, register_device on syn72
    (bench/cpu_rows.py's pair, 1,335 outer steps, 14 ICP events): s.

--only runs the cases whose name holds one of the words (e.g. `--only
syn72`).

Each is run once untimed (the kernels' build, the tables), then --reps
times (default 3); every rep is reported.  Prints the card's name and
power limit and the JSON (also to --json).  Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

SIMILAR = ["syn00", "syn01", "syn05", "syn06", "syn13", "syn07"]
TRIMMED = ["trm00", "trm01", "trm03", "trm13"]
STREAM_SIMILAR = [f"syn{i:02d}" for i in range(16)]
STREAM_TRIMMED = [f"trm{i:02d}" for i in range(8)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", default=None)
    ap.add_argument("--only", nargs="+", default=None, metavar="WORD")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("run_walls: needs a CUDA card", file=sys.stderr)
        return 2
    import goicp_tpu_torch
    from goicp_tpu_torch.bench import cpu_rows, launch_counts, measure
    from goicp_tpu_torch.search import chunked
    from goicp_tpu_torch.search.device_engine import register_device
    from goicp_tpu_torch.search.fused_stream import register_fused_stream

    dev = torch.device("cuda")
    cfg = measure.bench_shape(goicp_tpu_torch.GoICPConfig())
    cfg_t = dataclasses.replace(cfg, trimFraction=measure.TRIM_FRACTION,
                                trans_capacity=256)
    pools = {e[0]: e for e in measure.synthetic_pool(64, seed=7)}
    pools.update({e[0]: e for e in measure.synthetic_pool_trimmed(
        32, seed=23)})
    rows = measure.reference_rows()

    def bench(label):
        c, n = (cfg, 16) if label == "similar" else (cfg_t, 8)
        names = measure.similar_names(n) if label == "similar" else \
            [e[0] for e in measure.synthetic_pool_trimmed(n)]
        buckets = measure.build_batch_buckets(c, n, max_buckets=4,
                                              device=dev) \
            if label == "similar" else \
            measure.build_trimmed_batch_buckets(c, n, device=dev)
        torch.cuda.synchronize()
        wall, _ = measure.timed_pass(buckets, c, n, names, rows)
        return n / wall

    def batch(label):
        names, c = (SIMILAR, cfg) if label == "similar" else (TRIMMED,
                                                               cfg_t)
        pairs = measure._bucket_and_prepare(
            [measure._normalized_synthetic(pools[n]) for n in names], c,
            device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunked.register_device_batch_compact(pairs, c, chunk_steps=256,
                                              pad_to=8)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def fused(label):
        names, c = (STREAM_SIMILAR, cfg) if label == "similar" else (
            STREAM_TRIMMED, cfg_t)
        pairs = measure._bucket_and_prepare(
            [measure._normalized_synthetic(pools[n]) for n in names], c,
            device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        register_fused_stream(pairs, c, width=2, chunk_steps=512)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def syn72():
        c, pair = cpu_rows.bench_pair("syn72", dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        register_device(pair, c)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    cases = {
        "bench similar, pairs/s": lambda: bench("similar"),
        "bench trimmed, pairs/s": lambda: bench("trimmed"),
        "batch similar, s": lambda: batch("similar"),
        "batch trimmed, s": lambda: batch("trimmed"),
        "chunk of 512 steps, syn00-15, ms":
            lambda: launch_counts.stream_chunk(dev)["ms"],
        "fused similar w=2, s": lambda: fused("similar"),
        "fused trimmed w=2, s": lambda: fused("trimmed"),
        "syn72 register_device, s": syn72}
    if args.only:
        cases = {k: f for k, f in cases.items()
                 if any(w in k for w in args.only)}
    report = dict(card=launch_counts.card(), tree=goicp_tpu_torch.__file__,
                  reps=args.reps, walls={})
    for name, fn in cases.items():
        fn()
        report["walls"][name] = [fn() for _ in range(args.reps)]
        print(f"run_walls {name}: {report['walls'][name]}", flush=True)
    print(report["card"])
    line = json.dumps(report)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
