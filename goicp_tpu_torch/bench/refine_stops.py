"""Where the refine and initial routes' time goes on the card: csrc/icp.cu's
goicp_icp_refine (search/pick.py::icp_refine: an improving row's seeds,
ICP event, rescoring, pick and candidate's count in one launch) and
goicp_icp_init (pick.icp_init: an initial incumbent's ICP events, their
rescoring, the initial error and the pick in one launch), built with stop
points compiled in, each variant timed from a CUDA graph beside the ICP
event alone (goicp_icp_run) and the launches each route replaced (the
refine route: icp_seeds, icp_run, score_pick; the initial route: icp_run,
score_initial) on the same inputs.

    python -m goicp_tpu_torch.bench.refine_stops [--json PATH]
        [--events 0,2] [--no-initial]

A variant is csrc/icp.cu built with -DGOICP_REFINE_STOP=n (_build.variant,
all at once): 1 ends each cluster after its ICP loop (the prologue and the
loop: the refine route's seeds ranked from shared memory, the event; the
initial route's extra cluster skips the initial error); 2 after the split
rescoring's first barrier (every block's share of the points scored, the
values, counts and c-FPFH values in block 0), 3 after its ranks' barrier
(the trimmed placement; the same as 2 untrimmed), 4 after the rescorings,
the candidate's count and the initial error (block 0's sums and terms; no
ticket, no pick); the full route adds the ticket, the staging past L1 and
the pick.  The events are
bench/icp_stops.py's (0 syn07's 4-seed untrimmed event on its unpadded
pair, 2 trm00's count and dynamic trim on its bucket), refined as one row
whose lanes are the event's starts (ubs ascending, best nodes of width 0,
so the route's seeds are the event's R0 and t0 bit for bit) and whose
candidate is the first start; the initial route runs on the same pairs
at 4 seeds (init_seeds' starts) and 1 (the engines' default).  Every
kernel is timed in turns (the order forward, then reversed), each route's
full result held to the launches it replaced bit for bit.  Prints one
line an event and route, the card's name and power limit, and the JSON
(also to --json).  Needs a card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import sys

from goicp_tpu_torch.bench.probe import card, device_ms, setup

STOPS = {1: "prologue and ICP loop", 2: "+ the shares' values and counts",
         3: "+ the ranks", 4: "+ the sums and terms (the rescoring)",
         99: "+ ticket and pick (the full route)"}
VARIANTS = {n: (f"GOICP_REFINE_STOP={n}",) for n in (1, 2, 3, 4)}


def _same(a: dict, b: dict, keys) -> bool:
    import torch
    return all(torch.equal(a[k].reshape(-1).view(torch.uint8),
                           b[k].reshape(-1).view(torch.uint8)) for k in keys)


def _in_turns(fns: dict) -> dict:
    """graph_ms of each fn, timed in turns (forward, then reversed)."""
    order = list(fns) + list(fns)[::-1]
    times: dict = {name: [] for name in fns}
    for name in order:
        times[name].append(device_ms(fns[name]))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--events", default="0,2")
    ap.add_argument("--no-initial", action="store_true")
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
    from goicp_tpu_torch.search.args import REFINE_FIELDS, RefineRecord
    from goicp_tpu_torch.utils.fp32 import kernels

    logs: dict = {}
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(lambda n: _build.variant(
            ("icp.cu",), VARIANTS[n], stem=f"libgoicp_refine_stop_{n}",
            logs=logs), VARIANTS)))
    _build.library()
    ptxas = {str(n): {k: kernel_info(logs[f"libgoicp_refine_stop_{n}"], k)
                      for k in ("icp_refine_kernel", "icp_init_kernel")}
             for n in VARIANTS}
    ptxas["99"] = {k: kernel_info(_build.build_info.get("log", ""), k)
                   for k in ("icp_refine_kernel", "icp_init_kernel")}
    for n, info in ptxas.items():
        print(f"refine_stops ptxas, {STOPS[int(n)]}: {info}", flush=True)

    def with_lib(n, fn):
        pick.kernels = libs.get(n, kernels)
        try:
            return fn()
        finally:
            pick.kernels = kernels

    dev = torch.device("cuda")
    cfg, cfg_t, pools = setup()
    events = icp_events(cfg, cfg_t, pools, dev)
    own = {0: (prepare_pair(*_normalized_synthetic(pools["syn07"]), cfg,
                            device=dev), cfg),
           2: (_prepared("trm00", cfg_t, pools, dev), cfg_t)}
    report = dict(card=card(), torch=torch.__version__, ptxas=ptxas,
                  events={}, initial={})
    rec_keys = [k for k, _, _ in REFINE_FIELDS]
    init_keys = ("opt_err", "opt_R", "opt_t", "comp", "terms", "last_icp")
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
        names = ("three", 1, 2, 3, 4, 99)
        recs = {name: RefineRecord() for name in names}

        def route(n):
            return with_lib(n, lambda: pick.refine_rows(c, todo, 1, dev,
                                                        recs[n]))
        fns = {"icp_run": lambda: icp_run(data, model, R0, t0, **kw),
               "three": lambda: pick.refine_rows_by_launches(
                   c, todo, 1, dev, recs["three"]),
               **{n: (lambda n=n: route(n)) for n in names[1:]}}
        want = fns["three"]()
        got = route(99)
        torch.cuda.synchronize()
        if not _same(got, want, rec_keys):
            raise RuntimeError(f"event {e}: the route equals the three "
                               f"launches bit for bit")
        iters = icp_run(data, model, R0, t0, **kw).iters.tolist()
        times = _in_turns(fns)
        ms = {name: sum(v) / len(v) for name, v in times.items()}
        row = dict(K=K, iters=iters,
                   turns={str(k): v for k, v in times.items()},
                   graph_ms={str(k): v for k, v in ms.items()},
                   prologue_and_loop_us=(ms[1] - ms["icp_run"]) * 1e3,
                   shares_us=(ms[2] - ms[1]) * 1e3,
                   ranks_us=(ms[3] - ms[2]) * 1e3,
                   sums_and_terms_us=(ms[4] - ms[3]) * 1e3,
                   rescoring_and_count_us=(ms[4] - ms[1]) * 1e3,
                   ticket_and_pick_us=(ms[99] - ms[4]) * 1e3,
                   route_over_event_us=(ms[99] - ms["icp_run"]) * 1e3,
                   three_over_event_us=(ms["three"] - ms["icp_run"]) * 1e3)
        report["events"][label] = row
        print(f"refine_stops [{e}] {label}: K={K}, iterations {iters}; "
              f"graph_ms the event alone {ms['icp_run']:.4f}, the three "
              f"launches {ms['three']:.4f}, stops 1-4 {ms[1]:.4f} "
              f"{ms[2]:.4f} {ms[3]:.4f} {ms[4]:.4f}, the route {ms[99]:.4f}"
              f"; over the event: "
              f"the prologue and loop {row['prologue_and_loop_us']:+.2f} us,"
              f" the shares {row['shares_us']:+.2f}, the ranks "
              f"{row['ranks_us']:+.2f}, the sums and terms "
              f"{row['sums_and_terms_us']:+.2f} (the rescoring and count "
              f"{row['rescoring_and_count_us']:+.2f}), the ticket and pick "
              f"{row['ticket_and_pick_us']:+.2f} us; the route "
              f"{row['route_over_event_us']:+.2f} us, the three launches "
              f"{row['three_over_event_us']:+.2f} us", flush=True)
        if args.no_initial:
            continue
        for Ki in (4, 1):
            ci = dataclasses.replace(own[e][1], init_seeds=Ki)
            R0i, t0i = pick.init_seeds(Ki, dev)
            def init(n):
                return with_lib(n, lambda: pick.initial_incumbent(pair, ci))
            ifns = {"icp_run": lambda: icp_run(
                        pair.data, pair.model, R0i, t0i,
                        **pick.icp_kw(pair, ci)),
                    "two": lambda: pick.initial_incumbent_by_launches(
                        pair, ci),
                    **{n: (lambda n=n: init(n)) for n in (1, 4, 99)}}
            got, want = init(99), ifns["two"]()
            torch.cuda.synchronize()
            if not _same(got, want, init_keys):
                raise RuntimeError(f"event {e}: the initial route equals "
                                   f"the two launches bit for bit")
            times = _in_turns(ifns)
            ms = {name: sum(v) / len(v) for name, v in times.items()}
            irow = dict(K=Ki, turns={str(k): v for k, v in times.items()},
                        graph_ms={str(k): v for k, v in ms.items()},
                        loop_us=(ms[1] - ms["icp_run"]) * 1e3,
                        rescoring_and_initial_us=(ms[4] - ms[1]) * 1e3,
                        ticket_and_pick_us=(ms[99] - ms[4]) * 1e3,
                        route_over_event_us=(ms[99] - ms["icp_run"]) * 1e3,
                        two_over_event_us=(ms["two"] - ms["icp_run"]) * 1e3)
            report["initial"][f"{label}, {Ki} seeds"] = irow
            print(f"refine_stops [{e}] initial route, {Ki} seeds on "
                  f"{label.split(',')[0]}'s pair: graph_ms the event alone "
                  f"{ms['icp_run']:.4f}, the two launches {ms['two']:.4f}, "
                  f"stop 1 {ms[1]:.4f}, stop 4 {ms[4]:.4f}, the route "
                  f"{ms[99]:.4f}; over the event: the loop "
                  f"{irow['loop_us']:+.2f} us, the rescorings and the "
                  f"initial error {irow['rescoring_and_initial_us']:+.2f}, "
                  f"the ticket and pick {irow['ticket_and_pick_us']:+.2f}; "
                  f"the route {irow['route_over_event_us']:+.2f} us, the two "
                  f"launches {irow['two_over_event_us']:+.2f} us",
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
