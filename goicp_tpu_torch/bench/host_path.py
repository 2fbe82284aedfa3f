"""The host's cost of one call of each fixed-order wrapper of
utils/fp32.py on the card, and of each step a launch path is made of.

    python goicp_tpu_torch/bench/host_path.py [--calls N] [--json PATH]
        [--transition-only | --ladders-only | --wrappers-only]

Each number is time.perf_counter() around N calls (default 10,000) of one
thunk and a final torch.cuda.synchronize(), divided by N, in µs: the
host's time per call, since the kernels (~2 µs on the card) keep up with
it.  The wrappers run at the main path's shapes: ordered_sum over 4 rows
of 192 (the rescoring's sums), rotate of 192 points by 8 R (an outer
transition) and by 4 R with t (a rescoring), norm3 of 8 rotation centres,
sincos32 of 8 angles, rodrigues of 8 centres, rot_uncertainty of 8 widths
times 192 point norms, cross3 of chip_smoke.py phase 2's strided (4, 3)
operands (a column of one 3x3 against a row of another), dot_fma of (8, 3)
x (8, 3) and of the Kabsch's broadcast (4, 3, 1, 3) x (4, 1, 3, 3); each
beside the one torch call that computes the same function in another
order (torch.sum, torch.matmul, torch.baddbmm, torch.linalg.vector_norm,
torch.linalg.cross; sin and cos take two, and torch.sin alone is timed
too; rodrigues and rot_uncertainty have none).  The ladder builds
ordered_sum's call up from the bare C call one piece at a time, beside
the same call made the older way (as at commit 90724d7: a lookup per
call, c_void_p pointers, a Stream object); the norm3 ladder builds
norm3's call up the same way, with the output shaped by a torch.Size
(the wrapper before its host path was cut) and by its row count; the
steps are the pieces of a launch path,
each timed alone.  The cross3 and sincos32 ladders do the same for
those two calls.  --ladders-only times the three ladders alone,
--wrappers-only the wrappers alone.

The transition's wrappers (search/transition.py: harvest; advance in
modes pop, adopt and both) are timed at the streams' shape (syn02 +
syn03) and register_device's (syn07), up to each call's enqueue (their
card time is near their host path's), as the main path calls them and,
on a tree that keeps argument blocks and output sets, with a block
built and outputs allocated a call.

Like launch_counts.py, it times an older tree's wrappers when that tree
comes first on PYTHONPATH: where the older tree has no such function, the
composition its callers used is timed instead (rotate then + t;
cos32 and sin32), and a step it cannot take is null.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time

import torch


def _us(fn, calls: int) -> float:
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _inputs(dev):
    g = torch.Generator().manual_seed(5)

    def rand(*shape, lo=-1.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(*shape, generator=g)).to(dev)
    return dict(rows=rand(4, 192), pts=rand(192, 3, lo=-0.8, hi=0.8),
                R8=rand(8, 3, 3), R4=rand(4, 3, 3), t4=rand(4, 3, lo=-0.1,
                                                            hi=0.1),
                centers=rand(8, 3, lo=-2.0, hi=2.0),
                angles=rand(8, lo=0.0, hi=5.4), V=rand(4, 3, 3),
                U=rand(4, 3, 3))


def wrappers(dev, calls: int) -> dict:
    """µs per call of each wrapper (this tree's or the older one's) and of
    its library call."""
    from goicp_tpu_torch.bounds.evaluate import rot_uncertainty
    from goicp_tpu_torch.geom.rotation import rodrigues
    from goicp_tpu_torch.utils import fp32
    x = _inputs(dev)
    rows, pts, R8, R4, t4 = x["rows"], x["pts"], x["R8"], x["R4"], x["t4"]
    Vb, Ub = x["V"][..., :, None, :], x["U"][..., None, :, :]
    if hasattr(fp32, "sincos32"):
        def rotate_t():
            return fp32.rotate(R4, pts, t4)

        def sincos():
            return fp32.sincos32(x["angles"])
    else:
        def rotate_t():
            return fp32.rotate(R4, pts) + t4[..., None, :]

        def sincos():
            return fp32.sin32(x["angles"]), fp32.cos32(x["angles"])
    pts_b = pts.expand(4, 192, 3)
    ca, cb = x["V"][:, :, 0], x["U"][:, 1]
    widths = x["angles"] / 2.0
    norms = torch.linalg.vector_norm(pts, dim=-1)
    thunks = {
        "ordered_sum (4, 192)": lambda: fp32.ordered_sum(rows),
        "torch.sum": lambda: torch.sum(rows, dim=-1),
        "rotate (8, 3, 3) x (192, 3)": lambda: fp32.rotate(R8, pts),
        "torch.matmul (8 R)": lambda: torch.matmul(pts, R8.transpose(-1,
                                                                     -2)),
        "rotate (4, 3, 3) x (192, 3) + t": rotate_t,
        "torch.baddbmm (4 R, t)": lambda: torch.baddbmm(
            t4[:, None, :], pts_b, R4.transpose(-1, -2)),
        "norm3 (8, 3)": lambda: fp32.norm3(x["centers"]),
        "torch.linalg.vector_norm": lambda: torch.linalg.vector_norm(
            x["centers"], dim=-1),
        "sincos32 (8,)": sincos,
        "torch.sin + torch.cos": lambda: (torch.sin(x["angles"]),
                                          torch.cos(x["angles"])),
        "torch.sin": lambda: torch.sin(x["angles"]),
        "rodrigues (8, 3)": lambda: rodrigues(x["centers"]),
        "rot_uncertainty (8,) x (192,)": lambda: rot_uncertainty(widths,
                                                                 norms),
        "cross3 (4, 3) x (4, 3) strided": lambda: fp32.cross3(ca, cb),
        "torch.linalg.cross": lambda: torch.linalg.cross(ca, cb),
        "dot_fma (8, 3) x (8, 3)": lambda: fp32.dot_fma(x["centers"],
                                                        x["centers"]),
        "dot_fma (4, 3, 1, 3) x (4, 1, 3, 3)": lambda: fp32.dot_fma(Vb, Ub),
        "torch.matmul (Kabsch)": lambda: torch.matmul(
            x["V"], x["U"].transpose(-1, -2)),
    }
    return {k: _us(f, calls) for k, f in thunks.items()}


def ladder(dev, calls: int) -> dict:
    """µs per call of ordered_sum over (4, 192) built up step by step: the
    C call alone, then each piece of the wrapper added, up to the wrapper
    itself; and the same C call the older way (the library looked up
    per call, c_void_p pointers, a Stream object)."""
    from goicp_tpu_torch._build import library
    from goicp_tpu_torch.utils import fp32
    lib = library()
    a = _inputs(dev)["rows"]
    o = a.new_empty((4,))
    px, po, idx = a.data_ptr(), o.data_ptr(), a.get_device()
    raw = torch._C._cuda_getCurrentRawStream
    s = raw(idx)
    fn = lib.goicp_ordered_sum

    def with_output():
        out = a.new_empty((4,))
        return fn(a.data_ptr(), out.data_ptr(), 4, 192, 1, 32, raw(idx))

    def pr10_call():
        from goicp_tpu_torch._build import library
        out = torch.empty((4,), dtype=torch.float32, device=a.device)
        return getattr(library(), "goicp_ordered_sum")(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            4, 192, 1, 32, ctypes.c_void_p(
                torch.cuda.current_stream(a.device).cuda_stream))
    thunks = {
        "1. the C call, its arguments ready": lambda: fn(px, po, 4, 192, 1,
                                                         32, s),
        "2. + the stream handle read": lambda: fn(px, po, 4, 192, 1, 32,
                                                  raw(idx)),
        "3. + a new output, the pointers read": with_output,
        "4. + checks and shapes: fp32.ordered_sum": lambda: fp32.ordered_sum(
            a),
        "3 the older way (a lookup, c_void_p, a Stream object)":
            pr10_call,
    }
    return {k: _us(f, calls) for k, f in thunks.items()}


def norm3_ladder(dev, calls: int) -> dict:
    """µs per call of norm3 over the rotation centres' (8, 3) built up
    from the bare C call one piece of its wrapper at a time (as the
    wrapper was before its host path was cut: the output shaped by a
    torch.Size; then by the row count, an int); then, at (8, 3) and at
    the points' (192, 3), the wrapper itself and torch.linalg.vector_norm,
    timed in turns (forward, then in reverse: a list of the two)."""
    from goicp_tpu_torch.utils import fp32
    v = _inputs(dev)["centers"]
    o = v.new_empty((8,))
    fn = fp32.kernels.goicp_norm3
    pv, po, idx = v.data_ptr(), o.data_ptr(), v.get_device()
    raw = torch._C._cuda_getCurrentRawStream
    s = raw(idx)

    def size_output():
        out = v.new_empty(v.shape[:-1])
        return fn(pv, out.data_ptr(), out.numel(), raw(idx))

    def int_output():
        out = v.new_empty(8)
        return fn(pv, out.data_ptr(), 8, raw(idx))

    def size_wrapper():
        if not fp32._on_card(v):
            return None
        if v.dim() == 0 or v.shape[-1] != 3:
            raise ValueError
        w = v.contiguous()
        out = w.new_empty(w.shape[:-1])
        rows = out.numel()
        fp32._launch(fn(w.data_ptr(), out.data_ptr(), rows,
                        fp32._stream(w)), "norm3")
        return out
    thunks = {
        "1. the C call, its arguments ready": lambda: fn(pv, po, 8, s),
        "2. + the stream handle read": lambda: fn(pv, po, 8, raw(idx)),
        "3. + a new output shaped by a torch.Size": size_output,
        "3'. + a new output shaped by its row count": int_output,
        "4. + the checks, contiguous(), _launch (the wrapper before)":
            size_wrapper,
    }
    out = {k: _us(f, calls) for k, f in thunks.items()}
    turns = {}
    for name, x in (("", v), (" (192, 3)", _inputs(dev)["pts"])):
        turns.update({
            f"5. fp32.norm3{name}": lambda x=x: fp32.norm3(x),
            f"torch.linalg.vector_norm{name}":
                lambda x=x: torch.linalg.vector_norm(x, dim=-1)})
    for k in turns:
        out[k] = []
    for k in list(turns) + list(turns)[::-1]:
        out[k].append(_us(turns[k], calls))
    return out


def _in_turns_us(turns: dict, calls: int) -> dict:
    """µs per call of each thunk, timed forward then in reverse: a list
    of the two for each."""
    out = {k: [] for k in turns}
    for k in list(turns) + list(turns)[::-1]:
        out[k].append(_us(turns[k], calls))
    return out


def cross3_ladder(dev, calls: int) -> dict:
    """µs per call of cross3 at chip_smoke.py phase 2's strided (4, 3) x
    (4, 3) (a column of one 3x3 against a row of another), built up from
    the bare C call one piece of its wrapper at a time: the stream handle
    read, a new output (from the kept broadcast shape, a tuple, as the
    wrapper makes it, or from its ints), the description looked up per
    layout (_broadcast_view); then the wrapper and torch.linalg.cross in
    turns."""
    from goicp_tpu_torch.utils import fp32
    x = _inputs(dev)
    a, b = x["V"][:, :, 0], x["U"][:, 1]
    o = a.new_empty(4, 3)
    fn = fp32.kernels.goicp_cross3
    pa, pb, po, idx = a.data_ptr(), b.data_ptr(), o.data_ptr(), a.get_device()
    raw = torch._C._cuda_getCurrentRawStream
    s = raw(idx)
    shape, meta = fp32._broadcast_view(a.shape, a.stride(), b.shape,
                                       b.stride())

    def out_tuple():
        out = a.new_empty(shape)
        return fn(pa, pb, out.data_ptr(), meta, raw(idx))

    def out_ints():
        out = a.new_empty(*shape)
        return fn(pa, pb, out.data_ptr(), meta, raw(idx))

    def lookup():
        sh, m = fp32._broadcast_view(a.shape, a.stride(), b.shape,
                                     b.stride())
        out = a.new_empty(sh)
        return fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, raw(idx))
    thunks = {
        "1. the C call, its arguments ready": lambda: fn(pa, pb, po, meta,
                                                         s),
        "2. + the stream handle read": lambda: fn(pa, pb, po, meta,
                                                  raw(idx)),
    }
    out = {k: _us(f, calls) for k, f in thunks.items()}
    out.update(_in_turns_us({
        "3a. + a new output, new_empty(shape), a tuple": out_tuple,
        "3b. + a new output, new_empty(*shape), ints": out_ints,
        "4. + the description looked up (_broadcast_view)": lookup,
        "5. fp32.cross3": lambda: fp32.cross3(a, b),
        "torch.linalg.cross": lambda: torch.linalg.cross(a, b)}, calls))
    return out


def sincos32_ladder(dev, calls: int) -> dict:
    """µs per call of sincos32 at (8,) built up from the bare C call: its
    outputs made as two tensors (empty_like, as before its call was cut;
    new_empty from ints) or as one (2, n) tensor returned as its two rows
    (unbind, or a slice each), each with the C call; then the wrapper,
    torch.sin and torch.sin + torch.cos in turns."""
    from goicp_tpu_torch.utils import fp32
    x = _inputs(dev)["angles"]
    n = x.numel()
    o = x.new_empty(2, n)
    fn = fp32.kernels.goicp_sincos32
    px, po, idx = x.data_ptr(), o.data_ptr(), x.get_device()
    raw = torch._C._cuda_getCurrentRawStream
    s = raw(idx)

    def call(sp, cp):
        return fn(px, sp, cp, n, raw(idx))

    def empty_like():
        sv, cv = torch.empty_like(x), torch.empty_like(x)
        call(sv.data_ptr(), cv.data_ptr())
        return sv, cv

    def two_new():
        sv, cv = x.new_empty(n), x.new_empty(n)
        call(sv.data_ptr(), cv.data_ptr())
        return sv, cv

    def unbind():
        out = x.new_empty(2, n)
        p = out.data_ptr()
        call(p, p + 4 * n)
        return out.unbind(0)

    def slices():
        out = x.new_empty(2 * n)
        p = out.data_ptr()
        call(p, p + 4 * n)
        return out[:n], out[n:]
    thunks = {
        "1. the C call, its arguments ready": lambda: fn(px, po, po + 4 * n,
                                                         n, s),
        "2. + the stream handle read": lambda: call(po, po + 4 * n),
    }
    out = {k: _us(f, calls) for k, f in thunks.items()}
    out.update(_in_turns_us({
        "3a. + two outputs, empty_like": empty_like,
        "3b. + two outputs, new_empty(n)": two_new,
        "3c. + one (2, n) output, unbind": unbind,
        "3d. + one 2n output, two slices": slices,
        "4. fp32.sincos32": lambda: fp32.sincos32(x),
        "torch.sin": lambda: torch.sin(x),
        "torch.sin + torch.cos": lambda: (torch.sin(x), torch.cos(x))},
        calls))
    return out


def steps(dev, calls: int) -> dict:
    """µs per call of each piece of a launch path, alone."""
    from goicp_tpu_torch._build import library
    from goicp_tpu_torch.utils import fp32
    lib = library()
    x = _inputs(dev)
    a, pts = x["rows"], x["pts"]
    idx = a.get_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    Vb, Ub = x["V"][..., :, None, :], x["U"][..., None, :, :]
    kept = getattr(fp32, "kernels", None)

    def lookup():
        from goicp_tpu_torch._build import library
        return getattr(library(), "goicp_empty_launch")

    def meta():
        if hasattr(fp32, "_broadcast_view"):
            return fp32._broadcast_view(Vb.shape, Vb.stride(), Ub.shape,
                                        Ub.stride())
        m = fp32.broadcast_meta(*torch.broadcast_tensors(Vb, Ub))
        return (ctypes.c_longlong * len(m))(*m)
    thunks = {
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(a.device).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(index)":
            None if raw is None else (lambda: raw(idx)),
        "tensor.get_device()": a.get_device,
        "tensor.data_ptr()": a.data_ptr,
        "ctypes.c_void_p(data_ptr())": lambda: ctypes.c_void_p(a.data_ptr()),
        "import + library() + getattr (a lookup per call)": lookup,
        "kept symbol (kernels.<name>)":
            None if kept is None else (lambda: kept.goicp_empty_launch),
        "device check: set of device types":
            lambda: {t.device.type for t in (a, pts)} == {"cuda"},
        "device check: is_cpu / is_cuda":
            lambda: all(t.is_cpu for t in (a, pts)) or all(
                t.is_cuda for t in (a, pts)),
        "torch.empty(shape, dtype=, device=)":
            lambda: torch.empty((4,), dtype=torch.float32, device=a.device),
        "tensor.new_empty(shape)": lambda: a.new_empty((4,)),
        "contiguous() of a contiguous tensor": a.contiguous,
        "torch.broadcast_tensors (Kabsch)":
            lambda: torch.broadcast_tensors(Vb, Ub),
        "the Kabsch's broadcast description (kept per layout; before: "
        "broadcast_tensors, then a new c_longlong[15])": meta,
        "C call, empty kernel, stream as c_void_p":
            lambda: lib.goicp_empty_launch(ctypes.c_void_p(
                torch.cuda.current_stream(a.device).cuda_stream)),
        "C call, empty kernel, stream as an int":
            None if raw is None else (
                lambda: lib.goicp_empty_launch(raw(idx))),
    }
    return {k: None if f is None else _us(f, calls)
            for k, f in thunks.items()}


def _enqueue_us(fn, calls: int) -> float:
    """The host's µs per call of fn up to its last enqueue (no wait for
    the card at the end): a transition kernel's card time (~0.004-0.02
    ms) is near its host path's, so timing to a final synchronize would
    time the card.  calls stays below the launch queue's depth."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def transition(dev, calls: int = 400) -> dict:
    """µs per call (host, up to the enqueue) of the transition's wrappers
    at the streams' shape (syn02 + syn03, both rows, 40 global iterations
    in: harvest, and advance "both" written in place) and at
    register_device's (syn07's first outer step: advance "pop", harvest,
    advance "adopt", each given the 1-row views of the state and the
    inner search's results made anew a call, as the outer step makes
    them): "main" as the main path calls them on this tree (with a run's
    TransitionBuffers where the tree has them: argument blocks kept,
    outputs from two sets in turn), "per call" without them
    (a block built and outputs allocated a call; null on a tree without
    TransitionBuffers, whose every call is that)."""
    import inspect
    from goicp_tpu_torch.bench.launch_counts import _bench_pairs
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.search import device_engine as eng
    from goicp_tpu_torch.search import fused_stream as fs
    from goicp_tpu_torch.search import inner
    from goicp_tpu_torch.search import transition as tr
    has = "bufs" in inspect.signature(tr.advance).parameters
    try:
        from goicp_tpu_torch.search.args import TransitionBuffers
    except ImportError:         # an older tree keeps them in transition.py
        TransitionBuffers = getattr(tr, "TransitionBuffers", None)
    cfg, pairs = _bench_pairs(("syn02", "syn03"), dev, bucket_together=True)
    pb = stack_pairs(pairs)
    s = fs.fused_run_chunk(pb, cfg, fs._init_batch(pb, cfg), 40)
    tabs = fs._transition_tables(pb, cfg)
    rows = [0, 1]
    h = tr.harvest(cfg, s, rows)
    win = fs._map_state(torch.clone, s)
    cfg1, (pair,) = _bench_pairs(("syn07",), dev, bucket_together=False)
    pb1, tabs1 = eng._one_row(pair, cfg1)
    st = eng.device_init(pair, cfg1)
    p1 = tr.advance("pop", cfg1, pb1, eng._as_row(st), [0], tables=tabs1)
    res, lanes = inner.inner_bnb(
        pair, cfg1, p1["pts"][0], p1["widths"][0], p1["active"][0],
        st["opt_err"], False, True,
        lanes0={k: v[0] for k, v in p1["lanes"].items()}, mrd=p1["mrd"][0],
        raw=True)
    h1 = tr.harvest(cfg1, eng._harvest_src(dict(batch=p1), st["opt_err"],
                                           res), [0], lb=eng._lb_lanes(lanes))

    def thunks(kw):
        return {
            "harvest, the streams' 2 rows":
                lambda: tr.harvest(cfg, s, rows, **kw),
            "advance both in place, the streams' 2 rows":
                lambda: tr.advance("both", cfg, pb, win, rows, tables=tabs,
                                   h=h, out=win, **kw),
            "advance pop, syn07": lambda: tr.advance(
                "pop", cfg1, pb1, eng._as_row(st), [0], tables=tabs1, **kw),
            "harvest, syn07": lambda: tr.harvest(
                cfg1, eng._harvest_src(dict(batch=p1), st["opt_err"], res),
                [0], lb=eng._lb_lanes(lanes), **kw),
            "advance adopt, syn07": lambda: tr.advance(
                "adopt", cfg1, pb1, eng._as_row(st), [0], tables=tabs1, h=h1,
                p=p1, work=eng._work(res, res, True), **kw)}
    main = thunks({"bufs": TransitionBuffers()} if has else {})
    per_call = thunks({}) if has else None
    return {k: dict(main=_enqueue_us(f, calls),
                    per_call=None if per_call is None
                    else _enqueue_us(per_call[k], calls))
            for k, f in main.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=10_000)
    ap.add_argument("--json", help="also write the object to this file")
    ap.add_argument("--transition-only", action="store_true",
                    help="time the transition's wrappers alone")
    ap.add_argument("--ladders-only", action="store_true",
                    help="time the norm3, cross3 and sincos32 ladders "
                         "alone")
    ap.add_argument("--wrappers-only", action="store_true",
                    help="time the wrappers alone")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("host_path needs a CUDA device", file=sys.stderr)
        return 1
    import goicp_tpu_torch
    from goicp_tpu_torch.bench.launch_counts import card
    dev = torch.device("cuda")
    out = dict(package=goicp_tpu_torch.__file__, card=card(),
               calls=a.calls)
    if a.ladders_only or a.wrappers_only:
        if a.ladders_only:
            out.update(norm3_ladder_us=norm3_ladder(dev, a.calls),
                       cross3_ladder_us=cross3_ladder(dev, a.calls),
                       sincos32_ladder_us=sincos32_ladder(dev, a.calls))
        else:
            out["wrappers_us"] = wrappers(dev, a.calls)
        print(json.dumps(out), flush=True)
        if a.json:
            with open(a.json, "w") as fh:
                json.dump(out, fh)
        return 0
    if not a.transition_only:
        out.update(wrappers_us=wrappers(dev, a.calls),
                   ladder_us=ladder(dev, a.calls),
                   norm3_ladder_us=norm3_ladder(dev, a.calls),
                   cross3_ladder_us=cross3_ladder(dev, a.calls),
                   sincos32_ladder_us=sincos32_ladder(dev, a.calls),
                   steps_us=steps(dev, a.calls))
    out["transition_us"] = transition(dev)
    print(json.dumps(out), flush=True)
    if a.json:
        with open(a.json, "w") as fh:
            json.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
