"""Kernel launches of the loops the host dispatches, counted on the card
with torch.profiler (every kernel, torch's and the port's, from the
launch API events; host reads from torch's `_local_scalar_dense`, which
every `.item()` and `bool()` of a card tensor goes through):

  * one global iteration of the fused stream: the inner step of a window
    of two live rows (syn03 and syn12, whose searches are still live 3
    global iterations in; one launch of csrc/inner.cu on a tree that has
    it, K3, K4 and ~130 torch ops around them before);
  * one register_device inner iteration: inner_bnb's loop body on syn07's
    first outer step (its 8 lanes 3 iterations in), the step and the host
    read of its active-lane count (trees that have search/inner.py's
    inner_step); on a tree whose inner_step can write into a run's two
    output sets in turn (inner.StepBuffers), that iteration too (ms_bufs),
    timed in turns with the one that allocates its outputs (ms);
  * one ICP event: icp_run from four seeds on a bench pair (the outer
    step's icp_seeds) as the engine calls it, at the configuration's
    max_iter and err_diff: its launches, host reads, host-clock ms,
    icp_run's own launch count (csrc/icp.cu) and the rows' iterations;
  * one ICP iteration: the same event with its convergence test switched
    off so that it runs a fixed number of iterations; the launches of 3
    iterations less those of 2 (0 when the event is one launch);
  * one outer transition of the fused stream with its own harvest:
    fused_stream._transition_batch given no harvest, as fused_run_chunk
    ran it before its event head (the rows' new states
    written back into the window, with the loop's TransitionBuffers on a
    tree that has them), of every row of a window of TRANSITION_ROWS
    bench pairs, each call on a fresh copy of their first state
    (`transition`) and, as a loop's calls meet them, each call on the
    state the one before wrote, in place (`transition_chained`: a call
    finds the tensors of the call before, so a tree that keeps its
    argument blocks reuses them), where no row improves (so no ICP):
    harvest, adopt, merge, pop, rotate and the fresh inner state of each
    row; its launches, host reads, syncs (the host's waits on the card:
    reads, `.cpu()` copies and pageable host-to-card copies) and
    host-clock ms, and per row;
  * one outer transition of the packed stream: packed_stream.
    _transition, as packed_run_chunk runs it, of the same rows from their
    first packed state: the bundles unpacked into the fused layout, the
    fused stream's transition, the rows repacked and written back; its
    launches, host reads, syncs and host-clock ms, and per row;
  * one register_device outer step: device_engine._make_body's body on
    syn07, with the loop's host read of `converged` where the body does
    not read it itself: every step from the same state, 3 outer steps in
    (`outer_step`), and, as device_run_chunk runs it, each step fed the
    state the step before returned, from 7 steps in
    (`outer_step_chained`; syn07's steps 7-17 improve on no incumbent,
    so no ICP runs in them, where step 3's successors do): launches,
    host reads, syncs, host-clock ms, the inner
    iterations it ran, the launches of the inner search's own kernels
    (csrc/inner.cu: inner_step and inner_run, by their launch counts) and
    the launches and host reads beside them (less those launches and, on
    a tree whose inner search is a loop of steps, one host read per inner
    iteration: the loop's own);
  * one chunk of the fused stream: fused_run_chunk of a window of the 16
    bench pairs syn00-syn15 from their first state, STREAM_STEPS global
    iterations at most: the global iterations, transition events and host
    reads it counts (fused_stream.counters), host reads per global
    iteration, and host-clock ms; its launches (every kernel, counted by
    torch.profiler) and syncs, and host reads, launches and syncs per
    transition event;
  * one rescoring: score_transform of that pair at four seeded transforms
    and their nearest-neighbour correspondences (the ICP event's): one
    launch of csrc/score.cu on a tree that has it, ~85 before;
  * one improving step's refinement as register_device runs it
    (`refine`) on that pair's first outer step (its rotation lanes,
    seeded translation nodes and upper bounds): on a tree with
    search/pick.py, pick.refine_rows into a run's refine record (the
    seeds, the ICP event from the 4 lowest, the pick of the best seed
    with its rescoring and the candidate's BnB count, written into the
    record); before, device_engine._icp_best_of_seeds, the candidate's
    count and the refine block (transition.refine_rows, set_refine) as
    that tree's body made them: launches, host reads and host-clock ms,
    `ms` a call with the card's work (the larger of the two) and
    `host_ms` the host's own (timed up to the last call's return; one
    launch of csrc/icp.cu's refine route on a tree that has it, three on
    the tree before);
  * the refinement of a fused-stream window's two rows, both improving
    (`refine_window`), as _transition_batch makes it: pick.refine_rows
    over views of the window's stacked pairs and lanes made anew a call
    (WINDOW_REFINE, one bucket; each row its pair's first popped lanes,
    seeded translation nodes and upper bounds): launches, host reads,
    `ms` and `host_ms` (one launch on a tree with the refine route, six
    before);
  * the initial incumbent (`initial`): device_engine._initial_incumbent
    on that pair (the ICP from init_seeds starts, the rescoring, the
    initial error, the pick and the comparison), after one call (the
    seeds a tree keeps): launches, host reads, `ms` a call with the
    card's work and `host_ms` the host's own (one launch of csrc/icp.cu's
    initial route on a tree that has it, two on the tree before);
  * one rodrigues of 8 seeded rotation centres (the host engine's lanes)
    and one rot_uncertainty of their 8 widths times that pair's point
    norms: launches and host-clock ms a call (each one launch of
    csrc/fp32_products.cu on a tree that has them, their torch bodies
    before);
  * one outer step of the host engine (search/outer.py, run-pair --engine
    host): its device work on that pair, prepared with static counts as
    run_pair prepares it, at the bench's shape: step_bounds (rodrigues,
    rotate, the inner search with its rotation uncertainty) on the
    arguments the engine passed it at its first step (the root's 8
    children, its incumbent; recorded from a one-step run), and the one
    read of the results (outer.to_host): launches, host reads, syncs,
    host-clock ms.

    python goicp_tpu_torch/bench/launch_counts.py [--json PATH]
        [--only NAME ...]

--only counts the named entries alone (the keys of the printed object,
e.g. `--only rodrigues rot_uncertainty host_outer_step`).

prints one JSON object (the counts, each loop's host-clock ms, the card's
name and power limit, and ptxas's registers, stack frame and spills of
csrc/score.cu's kernels where the tree has it: the rescoring's, and the
pick's and the seeds' where it has them; and csrc/icp.cu's refine
and initial routes' where it has them; `inner_ptxas`: csrc/inner.cu's
four run kernels' and the harvest's).  It uses only
functions the port has had since its cross-pair streams, so the same
script counts an older tree's launches too: put that tree first on
PYTHONPATH (its icp_run has no launch count: null).  Needs a card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

PAIRS_STEP = ("syn03", "syn12")
TRANSITION_ROWS = ("syn00", "syn01", "syn02", "syn03", "syn04", "syn05",
                   "syn06", "syn07")
STREAM_ROWS = tuple(f"syn{i:02d}" for i in range(16))
STREAM_STEPS = 512
PAIR_ICP = "syn07"
WINDOW_REFINE = ("syn02", "syn03")
OUTER_FROM = 7      # syn07's outer steps 6, 19 and 27 improve (0-based)
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


def _profile(fn, n: int, syncs: bool = False) -> tuple:
    """(kernel launches, host reads) per call of fn over n profiled
    calls; syncs: also the host's waits on the card (stream syncs: a
    read's, a `.cpu()`'s and a pageable host-to-card copy's)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    names = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
    events = prof.key_averages()
    out = (sum(e.count for e in events if e.key in names) / n,
           sum(e.count for e in events
               if e.key == "aten::_local_scalar_dense") / n)
    if syncs:
        out += (sum(e.count for e in events
                    if e.key == "cudaStreamSynchronize") / n,)
    return out


def _launches(fn, n: int) -> float:
    """Kernel launches per call of fn over n profiled calls."""
    return _profile(fn, n)[0]


def _host_ms(fn, n: int) -> float:
    """Host-clock ms a call over n calls and the card's work they
    enqueued (the larger of the host's time and the card's)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _enqueue_ms(fn, n: int) -> float:
    """Host-clock ms a call of the host's own work: n calls timed up to
    the last one's return, the card left running (for calls that read
    nothing back and enqueue far fewer launches than the stream holds)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return ms


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


def one_pair_iteration(device="cuda", n=10) -> dict:
    """Launches, host reads and ms of one inner iteration of
    register_device: inner_bnb's loop body (the step with its counters,
    then the read of the active lanes) on syn07's first outer step; with
    inner.StepBuffers (a tree that has it), ms and ms_bufs each the mean
    of two runs of 20 n iterations in the order ms, ms_bufs, ms_bufs, ms."""
    from goicp_tpu_torch.bounds.evaluate import rot_uncertainty
    from goicp_tpu_torch.search import device_engine as eng
    from goicp_tpu_torch.search import inner
    cfg, (pair,) = _bench_pairs((PAIR_ICP,), device, bucket_together=False)
    p = eng._pop(pair, cfg, eng.device_init(pair, cfg))
    lanes = inner.initial_lanes(pair, cfg, p["pts"], p["active"],
                                eng.device_init(pair, cfg)["opt_err"])
    mrd = rot_uncertainty(p["widths"], pair.norm_data)
    cnt = {k: torch.zeros((1,), dtype=torch.int32, device=device)
           for k in ("evals", "geom_surv")}
    for _ in range(3):
        lanes, cnt, _ = inner.inner_step(pair, cfg, lanes, p["pts"], mrd,
                                         True, counters=cnt)

    def iteration(**kw):
        _, _, stats = inner.inner_step(pair, cfg, lanes, p["pts"], mrd, True,
                                       counters=cnt, **kw)
        return int(stats.n_active)
    launches, reads = _profile(iteration, n)
    out = dict(launches=launches, host_reads=reads)
    if hasattr(inner, "StepBuffers"):
        bufs = inner.StepBuffers()

        def with_bufs():
            return iteration(bufs=bufs)
        t = [_host_ms(f, 20 * n)
             for f in (iteration, with_bufs, with_bufs, iteration)]
        out.update(ms=(t[0] + t[3]) / 2, ms_bufs=(t[1] + t[2]) / 2)
    else:
        out["ms"] = _host_ms(iteration, 20 * n)
    return out


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


def transition(device="cuda", n=5, chained: bool = False) -> dict:
    """Launches, host reads and ms of one fused-stream transition of every
    row of a window of TRANSITION_ROWS pairs with its own harvest, as
    fused_run_chunk ran it before the event head (and as the packed
    stream's transition runs it: _transition_batch given no harvest):
    the rows' new states written into the window in place, with the
    loop's transition.TransitionBuffers on a tree that has them.  Each
    call on a fresh copy of the window's first state (the root popped);
    chained: each call on the window the call before wrote (no inner
    search between them: their lanes are fresh)."""
    import inspect
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.search import fused_stream as fs
    cfg, pairs = _bench_pairs(TRANSITION_ROWS, device, bucket_together=True)
    pb = stack_pairs(pairs)
    rows = list(range(len(pairs)))
    init = fs._init_batch(pb, cfg)
    params = inspect.signature(fs._transition_batch).parameters
    kw = {}
    if "bufs" in params:
        try:
            from goicp_tpu_torch.search.args import TransitionBuffers
        except ImportError:     # an older tree keeps them in transition.py
            from goicp_tpu_torch.search.transition import TransitionBuffers
        kw["bufs"] = TransitionBuffers()
    states = itertools.repeat(init) if chained else iter(
        [fs._map_state(torch.clone, init) for _ in range(4 * n + 4)])

    def step():
        s = next(states)
        if "in_place" in params:
            fs._transition_batch(pb, cfg, s, rows, in_place=True, **kw)
        else:
            for r, new in zip(rows, fs._transition_batch(pb, cfg, s, rows)):
                fs._write_row(s, r, new)
        return s
    step()                  # the window's tables, made once
    launches, reads, syncs = _profile(step, n, syncs=True)
    ms = _host_ms(step, 3 * n)
    return dict(rows=len(rows), launches=launches, host_reads=reads,
                syncs=syncs, ms=ms, launches_per_row=launches / len(rows),
                ms_per_row=ms / len(rows))


def packed_transition(device="cuda", n=5) -> dict:
    """Launches, host reads and ms of one packed-stream transition of every
    row of a window of TRANSITION_ROWS pairs (their first one), the rows
    written back into the packed window."""
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.search import fused_stream as fs
    from goicp_tpu_torch.search import packed_stream as ps
    cfg, pairs = _bench_pairs(TRANSITION_ROWS, device, bucket_together=True)
    pb = stack_pairs(pairs)
    rows = np.arange(len(pairs))
    init = ps.packed_init(pb, cfg)
    states = iter([fs._map_state(torch.clone, init)
                   for _ in range(4 * n + 4)])

    def step():
        s = next(states)
        ps._transition(pb, cfg, s, rows)
        return s
    step()                  # the window's tables, made once
    launches, reads, syncs = _profile(step, n, syncs=True)
    ms = _host_ms(step, 3 * n)
    return dict(rows=len(rows), launches=launches, host_reads=reads,
                syncs=syncs, ms=ms, launches_per_row=launches / len(rows),
                ms_per_row=ms / len(rows))


def outer_step(device="cuda", n=3, chained: bool = False) -> dict:
    """Launches, host reads and ms of one register_device outer step
    (device_engine._make_body's body, with the loop's read of `converged`
    where the body does not read it itself) on PAIR_ICP, and the inner
    iterations of the first: every step from the state 3 steps in; chained:
    each step fed the state the one before returned, as device_run_chunk
    runs it, from OUTER_FROM steps in (steps OUTER_FROM to OUTER_FROM + 10
    improve on no incumbent, so no ICP event runs in them)."""
    from goicp_tpu_torch.search import device_engine as eng
    cfg, (pair,) = _bench_pairs((PAIR_ICP,), device, bucket_together=False)
    s0 = eng.device_run_chunk(pair, cfg, eng.device_init(pair, cfg),
                              OUTER_FROM if chained else 3)
    body = eng._make_body(pair, cfg)
    state = [s0]

    def step():
        out = body(state[0])
        if isinstance(out, tuple):
            out = out[0]
        else:
            bool(out["converged"])      # the loop's read on such a tree
        if chained:
            state[0] = out
        return out
    from goicp_tpu_torch.search import inner as inner_mod
    kernels = [getattr(inner_mod, k) for k in ("inner_step", "inner_run")
               if hasattr(getattr(inner_mod, k, None), "launches")]
    s1 = step()
    inner = int(s1["inner_it"]) - int(s0["inner_it"])
    before = sum(k.launches for k in kernels)
    launches, reads, syncs = _profile(step, n, syncs=True)
    own = (sum(k.launches for k in kernels) - before) / n
    # a loop of steps reads the host once an inner iteration; a run, never
    loop_reads = 0 if hasattr(inner_mod, "inner_run") else inner
    return dict(launches=launches, host_reads=reads, syncs=syncs,
                ms=_host_ms(step, 2 * n), inner_iterations=inner,
                inner_launches=own, launches_besides_inner=launches - own,
                host_reads_besides_inner=reads - loop_reads)


def stream_chunk(device="cuda") -> dict:
    """One fused_run_chunk of STREAM_STEPS global iterations at most over
    a window of STREAM_ROWS from their first state: what the stream's own
    counters count (global iterations, transition events, host reads) and
    the host reads per global iteration, with its host-clock ms; then the
    same chunk under torch.profiler: its kernel launches (every kernel,
    torch's and the port's) and syncs, and the host reads, launches and
    syncs per transition event."""
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.search import fused_stream as fs
    cfg, pairs = _bench_pairs(STREAM_ROWS, device, bucket_together=True)
    pb = stack_pairs(pairs)
    init = fs._init_batch(pb, cfg)
    fs.fused_run_chunk(pb, cfg, init, 4)        # the window's tables
    torch.cuda.synchronize()
    fs.reset_counters()
    t0 = time.perf_counter()
    fs.fused_run_chunk(pb, cfg, init, STREAM_STEPS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    c = dict(fs.counters)
    launches, _, syncs = _profile(
        lambda: fs.fused_run_chunk(pb, cfg, init, STREAM_STEPS), 1,
        syncs=True)
    e = max(c["transitions"], 1)
    return dict(rows=len(pairs), steps=STREAM_STEPS,
                global_iters=c["global_iters"],
                transitions=c["transitions"], host_reads=c["host_reads"],
                host_reads_per_global_iter=c["host_reads"]
                / max(c["global_iters"], 1), ms=ms, launches=launches,
                syncs=syncs, host_reads_per_event=c["host_reads"] / e,
                launches_per_event=launches / e, syncs_per_event=syncs / e)


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


def refine(device="cuda", n=10) -> dict:
    """Launches, host reads and host-clock ms of an improving step's
    refinement as register_device's body makes it, on PAIR_ICP's first
    outer step (the module docstring's `refine`)."""
    from goicp_tpu_torch.search import device_engine as eng
    cfg, (pair,) = _bench_pairs((PAIR_ICP,), device, bucket_together=False)
    R_lanes = eng._pop(pair, cfg, eng.device_init(pair, cfg))["R_lanes"]
    L = R_lanes.shape[0]
    rng = np.random.default_rng(10)
    nodes = torch.as_tensor(np.concatenate(
        [rng.uniform(-0.05, 0.05, (L, 3)), np.full((L, 1), 0.02)], axis=1),
        dtype=torch.float32, device=device)
    ubs = torch.as_tensor(rng.uniform(0.5, 2.0, L), dtype=torch.float32,
                          device=device)
    cand_R, cand_t = R_lanes[0].contiguous(), nodes[0, :3] + nodes[0, 3] / 2
    try:
        from goicp_tpu_torch.search import pick
        from goicp_tpu_torch.search.args import RefineRecord
    except ImportError:         # a tree before the pick was one launch
        pick = None
    if pick is not None:
        record = RefineRecord()

        def step():
            return pick.refine_rows(
                cfg, [(0, pair, R_lanes, nodes, ubs, cand_R, cand_t)], 1,
                pair.device, record)
    else:
        from goicp_tpu_torch.bounds.error import bnb_incompatibility_count
        from goicp_tpu_torch.search import transition

        def step():
            icp_R, icp_t, sc, icp_incomp = eng._icp_best_of_seeds(
                pair, cfg, R_lanes, nodes, ubs)
            dummy = getattr(transition, "dummy_refine_rows", None) \
                or transition.refine_rows     # the name before
            r = dummy(1, pair.device)
            transition.set_refine(r, 0, dict(
                icp_R=icp_R, icp_t=icp_t, icp_err=sc.error,
                icp_terms=torch.stack([sc.geom, sc.incomp_term
                                       + sc.nbr_term, sc.fpfh_term]),
                icp_incomp=icp_incomp.to(torch.int32),
                bnb_comp=bnb_incompatibility_count(
                    pair, cfg, cand_R, cand_t).to(torch.int32)))
            return r
    step()
    launches, reads = _profile(step, n)
    return dict(launches=launches, host_reads=reads,
                ms=_host_ms(step, 5 * n), host_ms=_enqueue_ms(step, 2 * n))


def refine_window(device="cuda", n=10) -> dict:
    """Launches, host reads and host-clock ms of the refinement of a
    fused-stream window's two improving rows (the module docstring's
    `refine_window`)."""
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.search import device_engine as eng
    from goicp_tpu_torch.search import fused_stream as fs
    from goicp_tpu_torch.search import pick
    from goicp_tpu_torch.search.args import RefineRecord
    cfg, pairs = _bench_pairs(WINDOW_REFINE, device, bucket_together=True)
    pb = stack_pairs(pairs)
    W = len(pairs)
    R_lanes = torch.stack([eng._pop(p, cfg, eng.device_init(p, cfg))[
        "R_lanes"] for p in pairs])
    L = R_lanes.shape[1]
    rng = np.random.default_rng(11)
    nodes = torch.as_tensor(np.concatenate(
        [rng.uniform(-0.05, 0.05, (W, L, 3)), np.full((W, L, 1), 0.02)],
        axis=2), dtype=torch.float32, device=device)
    ubs = torch.as_tensor(rng.uniform(0.5, 2.0, (W, L)), dtype=torch.float32,
                          device=device)
    cand_R = R_lanes[:, 0].contiguous()
    cand_t = nodes[:, 0, :3] + nodes[:, 0, 3:] / 2
    record = RefineRecord()

    def step():
        return pick.refine_rows(
            cfg, [(j, fs._pair_row(pb, j), R_lanes[j], nodes[j], ubs[j],
                   cand_R[j], cand_t[j]) for j in range(W)], W, pb.device,
            record)
    step()
    launches, reads = _profile(step, n)
    return dict(rows=W, launches=launches, host_reads=reads,
                ms=_host_ms(step, 5 * n), host_ms=_enqueue_ms(step, 2 * n))


def initial(device="cuda", n=10) -> dict:
    """Launches, host reads and host-clock ms of the initial incumbent
    (device_engine._initial_incumbent) on PAIR_ICP, after one call."""
    from goicp_tpu_torch.search import device_engine as eng
    cfg, (pair,) = _bench_pairs((PAIR_ICP,), device, bucket_together=False)

    def call():
        return eng._initial_incumbent(pair, cfg)
    call()
    launches, reads = _profile(call, n)
    return dict(launches=launches, host_reads=reads,
                ms=_host_ms(call, 5 * n), host_ms=_enqueue_ms(call, 2 * n))


def _score_ptxas() -> list | None:
    """ptxas's lines for csrc/score.cu's kernels (the rescoring, the pick,
    the seeds) and for csrc/icp.cu's refine and initial routes where the
    tree has them,
    from the kernel library's build log (None for a tree without
    csrc/score.cu)."""
    from goicp_tpu_torch import _build
    if not (_build.CSRC / "score.cu").exists():
        return None
    from goicp_tpu_torch.bench.icp_stops import kernel_info
    _build.library()
    log = _build.build_info.get("log", "")
    return [x for k in ("score_kernel", "pick_kernel", "icp_seeds_kernel",
                        "icp_refine_kernel", "icp_init_kernel")
            for x in kernel_info(log, k)]


def _inner_ptxas() -> list:
    """ptxas's lines for csrc/inner.cu's run kernels (the four routes) and
    csrc/transition.cu's harvest and event head, from the kernel
    library's build log (the names a tree has)."""
    from goicp_tpu_torch import _build
    from goicp_tpu_torch.bench.icp_stops import kernel_info
    _build.library()
    log = _build.build_info.get("log", "")
    return [x for k in ("inner_run_kernel", "harvest_kernel", "event_kernel")
            for x in kernel_info(log, k)]


def _static_pair(name, device):
    """(cfg, pair): a bench pair prepared with static counts, as the host
    engine takes it (run_pair's preparation), at the bench's shape."""
    from goicp_tpu_torch.bench.measure import (_normalized_synthetic,
                                               bench_shape, synthetic_pool)
    from goicp_tpu_torch.config import GoICPConfig
    from goicp_tpu_torch.pipeline.prepare import prepare_pair
    cfg = bench_shape(GoICPConfig())
    pool = {e[0]: e for e in synthetic_pool(64, seed=7)}
    return cfg, prepare_pair(*_normalized_synthetic(pool[name]), cfg,
                             device=device)


def _first_step_args(pair, cfg) -> tuple:
    """(centers, widths, active, opt) of the host engine's first outer
    step on pair, as outer.register passes them to outer.step_bounds:
    recorded from a run of one outer step, so that the lanes are the
    engine's own expansion of the root's children and opt its own
    incumbent."""
    import dataclasses

    from goicp_tpu_torch.search import outer
    seen = []
    step_bounds = outer.step_bounds

    def record(*args):
        seen.append(args[2:])
        return step_bounds(*args)
    outer.step_bounds = record
    try:
        outer.register(pair, dataclasses.replace(cfg, max_outer_steps=1))
    finally:
        outer.step_bounds = step_bounds
    return seen[0]


def rodrigues_call(device="cuda", n=20) -> dict:
    """Launches and host-clock ms of one rodrigues of 8 seeded rotation
    centres (its own launch count on a tree that keeps one)."""
    from goicp_tpu_torch.geom.rotation import rodrigues
    rng = np.random.default_rng(14)
    v = torch.as_tensor(rng.uniform(-1.8, 1.8, (8, 3)), dtype=torch.float32,
                        device=device)
    return dict(launches=_launches(lambda: rodrigues(v), n),
                ms=_host_ms(lambda: rodrigues(v), 50 * n))


def rot_uncertainty_call(device="cuda", n=20) -> dict:
    """Launches and host-clock ms of one rot_uncertainty of 8 widths (the
    BnB's 2 pi / 2^k, k = 1..8) times PAIR_ICP's point norms."""
    from goicp_tpu_torch.bounds.evaluate import rot_uncertainty
    _, pair = _static_pair(PAIR_ICP, device)
    w = torch.tensor([2 * np.pi / 2 ** k for k in range(1, 9)],
                     dtype=torch.float32, device=device)

    def call():
        return rot_uncertainty(w, pair.norm_data)
    return dict(launches=_launches(call, n), ms=_host_ms(call, 50 * n),
                lanes=8, points=int(pair.norm_data.shape[0]))


def host_outer_step(device="cuda", n=5) -> dict:
    """Launches, host reads, syncs and host-clock ms of the device work of
    the host engine's first outer step on PAIR_ICP (the root's children,
    from the engine's incumbent after its initial ICP): outer.step_bounds
    on the arguments the engine passed it, and the one read of its
    results."""
    from goicp_tpu_torch.search import outer
    cfg, pair = _static_pair(PAIR_ICP, device)
    centers, widths, active, opt = _first_step_args(pair, cfg)

    def step():
        R, ub, lb = outer.step_bounds(pair, cfg, centers, widths, active,
                                      opt)
        return outer.to_host(R, ub.best_err, ub.best_node, ub.ub_terms,
                             ub.evals, lb.lb_safe, lb.evals)
    step()
    launches, reads, syncs = _profile(step, n, syncs=True)
    return dict(lanes=int(centers.shape[0]), active=int(active.sum()),
                launches=launches, host_reads=reads, syncs=syncs,
                ms=_host_ms(step, 4 * n))


def _has_inner_step() -> bool:
    from goicp_tpu_torch.search import inner
    return hasattr(inner, "inner_step")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the object to this file")
    ap.add_argument("--only", nargs="+", metavar="NAME",
                    help="count these entries alone")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_counts needs a CUDA device", file=sys.stderr)
        return 1
    import goicp_tpu_torch
    entries = {
        "global_iteration": global_iteration,
        "one_pair_iteration": lambda: one_pair_iteration()
        if _has_inner_step() else None,
        "icp_iteration": icp_iteration, "icp_event": icp_event,
        "transition": transition,
        "transition_chained": lambda: transition(chained=True),
        "packed_transition": packed_transition,
        "outer_step": outer_step,
        "outer_step_chained": lambda: outer_step(chained=True),
        "stream_chunk": stream_chunk, "rescoring": rescoring,
        "refine": refine, "refine_window": refine_window,
        "initial": initial, "score_ptxas": _score_ptxas,
        "inner_ptxas": _inner_ptxas,
        "rodrigues": rodrigues_call, "rot_uncertainty": rot_uncertainty_call,
        "host_outer_step": host_outer_step}
    unknown = set(a.only or ()) - set(entries)
    if unknown:
        ap.error(f"no such entries: {sorted(unknown)}")
    out = dict(package=goicp_tpu_torch.__file__, card=card())
    out.update({k: f() for k, f in entries.items()
                if a.only is None or k in a.only})
    print(json.dumps(out), flush=True)
    if a.json:
        with open(a.json, "w") as fh:
            json.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
