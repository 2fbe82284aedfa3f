"""Where the refine route's time goes on the card: csrc/icp.cu's
goicp_icp_refine (search/pick.py::icp_refine: an improving row's seeds,
ICP event, rescoring, pick and candidate's count in one launch) built
with stop points compiled in, each variant timed from a CUDA graph beside
the ICP event alone (goicp_icp_run) and the three launches the route
replaced (icp_seeds, icp_run, score_pick) on the same inputs.

    python -m goicp_tpu_torch.bench.refine_stops [--json PATH]
        [--events 0,2]

A variant is csrc/icp.cu built with -DGOICP_REFINE_STOP=n (_build.variant,
all at once): 1 ends each cluster after its ICP loop (the prologue and the
loop: the seeds' ranks from shared memory, the event), 2 after the
rescoring and the candidate's count (no ticket, no pick); the full route
adds the ticket, the staging past L1 and the pick.  The events are
bench/icp_stops.py's (0 syn07's 4-seed untrimmed event on its unpadded
pair, 2 trm00's count and dynamic trim on its bucket), refined as one
row whose lanes are the event's starts (ubs ascending, best nodes of
width 0, so the route's seeds are the event's R0 and t0 bit for bit) and
whose candidate is the first start.  Every kernel is timed in turns (the
order forward, then reversed), the route's full result held to the three
launches' bit for bit.  Prints one line an event, the card's name and
power limit, and the JSON (also to --json).  Needs a card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import sys

from goicp_tpu_torch.bench.probe import card, device_ms, setup

STOPS = {1: "prologue and ICP loop", 2: "+ rescoring and count",
         99: "+ ticket and pick (the full route)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--events", default="0,2")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("refine_stops: needs a CUDA card", file=sys.stderr)
        return 2
    from goicp_tpu_torch import _build
    from goicp_tpu_torch.bench.icp_stops import (_prepared, icp_events,
                                                 kernel_info)
    from goicp_tpu_torch.bench.measure import _normalized_synthetic
    from goicp_tpu_torch.icp.icp import icp_run
    from goicp_tpu_torch.pipeline.prepare import prepare_pair
    from goicp_tpu_torch.search import pick
    from goicp_tpu_torch.search.args import RefineRecord
    from goicp_tpu_torch.utils.fp32 import kernels

    logs: dict = {}
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        libs = dict(zip((1, 2), ex.map(lambda n: _build.variant(
            ("icp.cu",), (f"GOICP_REFINE_STOP={n}",),
            stem=f"libgoicp_refine_stop{n}", logs=logs), (1, 2))))
    _build.library()
    ptxas = {n: kernel_info(logs[f"libgoicp_refine_stop{n}"],
                            "icp_refine_kernel") for n in (1, 2)}
    ptxas[99] = kernel_info(_build.build_info.get("log", ""),
                            "icp_refine_kernel")
    for n, info in ptxas.items():
        print(f"refine_stops ptxas, {STOPS[n]}: {info}", flush=True)

    dev = torch.device("cuda")
    cfg, cfg_t, pools = setup()
    events = icp_events(cfg, cfg_t, pools, dev)
    own = {0: (prepare_pair(*_normalized_synthetic(pools["syn07"]), cfg,
                            device=dev), cfg),
           2: (_prepared("trm00", cfg_t, pools, dev), cfg_t)}
    report = dict(card=card(), torch=torch.__version__, ptxas=ptxas,
                  events={})
    for e in (int(x) for x in args.events.split(",") if x):
        label, data, model, R0, t0, kw = events[e]
        pair, c = own[e]
        if not torch.equal(pair.data, data):
            raise RuntimeError(f"event {e}: the pair's data is the event's")
        K = R0.shape[0]
        c = dataclasses.replace(c, icp_seeds=K)
        nodes = torch.cat([t0, torch.zeros_like(t0[:, :1])], 1).contiguous()
        ubs = torch.arange(K, dtype=torch.float32, device=dev)
        todo = [(0, pair, R0.contiguous(), nodes, ubs, R0[0].contiguous(),
                 t0[0].contiguous())]
        recs = {name: RefineRecord() for name in ("three", 1, 2, 99)}

        def route(n):
            pick.kernels = libs.get(n, kernels)
            try:
                return pick.refine_rows(c, todo, 1, dev, recs[n])
            finally:
                pick.kernels = kernels
        fns = {"icp_run": lambda: icp_run(data, model, R0, t0, **kw),
               "three": lambda: pick.refine_rows_by_launches(
                   c, todo, 1, dev, recs["three"]),
               **{n: (lambda n=n: route(n)) for n in (1, 2, 99)}}
        got, want = route(99), fns["three"]()
        torch.cuda.synchronize()
        same = all(torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8))
                   for a, b in zip(got.values(), want.values()))
        if not same:
            raise RuntimeError(f"event {e}: the route equals the three "
                               f"launches bit for bit")
        iters = icp_run(data, model, R0, t0, **kw).iters.tolist()
        order = list(fns) + list(fns)[::-1]
        times: dict = {name: [] for name in fns}
        for name in order:
            times[name].append(device_ms(fns[name]))
        ms = {name: sum(v) / len(v) for name, v in times.items()}
        row = dict(K=K, iters=iters, turns={str(k): v for k, v in
                                             times.items()},
                   graph_ms={str(k): v for k, v in ms.items()},
                   prologue_and_loop_us=(ms[1] - ms["icp_run"]) * 1e3,
                   rescoring_and_count_us=(ms[2] - ms[1]) * 1e3,
                   ticket_and_pick_us=(ms[99] - ms[2]) * 1e3,
                   route_over_event_us=(ms[99] - ms["icp_run"]) * 1e3,
                   three_over_event_us=(ms["three"] - ms["icp_run"]) * 1e3)
        report["events"][label] = row
        print(f"refine_stops [{e}] {label}: K={K}, iterations {iters}; "
              f"graph_ms the event alone {ms['icp_run']:.4f}, the three "
              f"launches {ms['three']:.4f}, stop 1 {ms[1]:.4f}, stop 2 "
              f"{ms[2]:.4f}, the route {ms[99]:.4f}; over the event: the "
              f"prologue and loop {row['prologue_and_loop_us']:+.2f} us, "
              f"the rescoring and count {row['rescoring_and_count_us']:+.2f}"
              f" us, the ticket and pick {row['ticket_and_pick_us']:+.2f} "
              f"us, the route {row['route_over_event_us']:+.2f} us, the "
              f"three launches {row['three_over_event_us']:+.2f} us",
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
