"""One answer on both devices: the port's own CPU rows, and the card held
to them step by step.

    python -m goicp_tpu_torch.bench.cpu_rows --write [NAME ...]

registers bench pairs (default: syn72) with the port's `register_device`
on the CPU, one intra-op thread, and writes their rows to
`goicp_tpu_torch/bench/cpu_rows.jsonl` (syn72: ~7 min).  chip_smoke.py
holds the card's registration of each pair to its row, bit for bit.

    python -m goicp_tpu_torch.bench.cpu_rows --trace syn72 [--until-split]

steps `register_device` of a bench pair on the card and on the CPU side by
side, one outer step at a time, and prints the first step whose search
state differs between the two devices in any bit, the first whose counters
or incumbent differ, and the first differing value: each piece of that
step (the rotated points, the inner search's bound sums, the ICP and its
rescoring, at the initial incumbent the identity error and the seeded
ICP) is rerun on both devices from the CPU's inputs, and the first piece
whose outputs differ is named with its first differing entries.
--until-split stops at the first split of the counters.  Needs a card.

`pair_results` computes what chip_smoke.py phase 13 holds the card to the
CPU on for each bench pair, and `write_pair_results` the CPU's side of it
(run in a child process while the card computes its own).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import pathlib
import sys

import numpy as np
import torch

from goicp_tpu_torch.bench.measure import (TRIM_FRACTION,
                                           _normalized_synthetic, bench_shape,
                                           synthetic_pool,
                                           synthetic_pool_trimmed)
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.pipeline.prepare import make_count_dynamic, prepare_pair
from goicp_tpu_torch.search import device_engine as eng

CPU_ROWS = pathlib.Path(__file__).with_name("cpu_rows.jsonl")
ROW_PAIRS = ("syn72",)
BENCH_PAIRS = [f"syn{i:02d}" for i in range(64)] + \
    [f"trm{i:02d}" for i in range(32)]


def bench_pair(name: str, device):
    """(cfg, pair) of a bench pair under GoICPConfig() + bench_shape (the
    trimmed pool's trimFraction and frontier for `trm*`), prepared in its
    own shape bucket, count-dynamic, on `device`: the pair of the fp32
    reference rows."""
    cfg = bench_shape(GoICPConfig())
    trimmed = name.startswith("trm")
    if trimmed:
        cfg = dataclasses.replace(cfg, trimFraction=TRIM_FRACTION,
                                  trans_capacity=256)
    n = int(name[3:]) + 1    # both draws are prefix-stable
    pool = synthetic_pool_trimmed(n, seed=23) if trimmed \
        else synthetic_pool(n, seed=7)
    entry = next(e for e in pool if e[0] == name)
    raw = _normalized_synthetic(entry)
    return cfg, make_count_dynamic(prepare_pair(*raw, cfg, bucket=True,
                                                device=device))


def row_of(res: eng.DeviceResult) -> dict:
    """A registration's counters, and its float results as float32 bit
    patterns (exact equality is the check)."""
    def bits(x):
        return torch.as_tensor(x).detach().cpu().contiguous().reshape(-1) \
            .view(torch.int32).tolist()
    return dict(outer=int(res.outer_iters), inner=int(res.inner_iters),
                evals=int(res.evals), icp_runs=int(res.icp_runs),
                opt_comp=int(res.opt_comp), converged=bool(res.converged),
                last_icp=bool(res.last_icp), error=float(res.error),
                bits=dict(error=bits(res.error), R=bits(res.R),
                          t=bits(res.t), terms=bits(res.terms),
                          gap=bits(res.gap)))


def read_rows(path=CPU_ROWS) -> dict:
    with open(path) as fh:
        return {r["pair"]: r for r in map(json.loads, fh)}


def write_rows(names=ROW_PAIRS, path=CPU_ROWS):
    torch.set_num_threads(1)
    with open(path, "w") as fh:
        for name in names:
            cfg, pair = bench_pair(name, "cpu")
            row = row_of(eng.register_device(pair, cfg))
            fh.write(json.dumps({"pair": name, **row}) + "\n")
            print(json.dumps({"pair": name, **row}), flush=True)


def pair_results(pair, cfg, seed: int = 13) -> dict:
    """A prepared pair's results on its own device, from seeded inputs:
    initial_error, rodrigues of 8 rotations and the data rotated by them,
    one ICP event from the identity and 4 starts near it with its
    rescoring (the engine's _icp_from), score_transform at the 8
    rotations with their nearest-neighbour correspondences, and the
    initial incumbent (the engine's _initial_incumbent: its ICP event and
    pick).  Tensors are moved to the CPU."""
    from goicp_tpu_torch.bounds.error import initial_error, score_transform
    from goicp_tpu_torch.geom.rotation import rodrigues
    from goicp_tpu_torch.icp.icp import nn_correspondences
    from goicp_tpu_torch.utils.fp32 import rotate
    rng = np.random.default_rng(seed)
    rv8 = rng.uniform(-2.5, 2.5, (8, 3)).astype(np.float32)
    rv_icp = np.vstack([np.zeros((1, 3)),
                        rng.uniform(-0.3, 0.3, (4, 3))]).astype(np.float32)
    t_icp = np.vstack([np.zeros((1, 3)),
                       rng.uniform(-0.05, 0.05, (4, 3))]).astype(np.float32)
    d = pair.device
    R8 = rodrigues(torch.as_tensor(rv8, device=d))
    pts = rotate(R8, pair.data)
    nn, _ = nn_correspondences(pts, pair.model)
    return _to({
        "initial_error": initial_error(pair, cfg),
        "8 rotations and rotated points": (R8, pts),
        "ICP event from the identity and 4 starts + rescoring":
            eng._icp_from(pair, cfg, rodrigues(torch.as_tensor(rv_icp,
                                                               device=d)),
                          torch.as_tensor(t_icp, device=d)),
        "score_transform at the 8 rotations": score_transform(
            pair, cfg, R8, torch.zeros((8, 3), device=d), nn),
        "the initial incumbent": eng._initial_incumbent(pair, cfg)}, "cpu")


def pair_digest(pair) -> dict:
    """{leaf: sha256 of its dtype, shape and bytes} of a prepared pair."""
    out = {}
    for name, t in _leaves(pair):
        t = t.detach().cpu().contiguous()
        h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes()
                 if t.numel() else b"")
        out[name] = h.hexdigest()
    return out


def write_pair_results(path: str, names=BENCH_PAIRS, device="cpu"):
    """torch.save {name: (pair_digest, pair_results)} of bench pairs
    prepared on `device`."""
    out = {}
    for name in names:
        cfg, pair = bench_pair(name, device)
        out[name] = (pair_digest(pair), pair_results(pair, cfg))
    torch.save(out, path)


# ---------------------------------------------------------------------------
# the card against the CPU, step by step
# ---------------------------------------------------------------------------

def _to(x, device):
    """Tensors of a (nested) dict / tuple / NamedTuple moved to device."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    return x


def _leaves(x, prefix=""):
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name),
                               f"{prefix}.{f.name}" if prefix else f.name)
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for k, v in zip(x._fields, x):
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{prefix}[{i}]")
    elif isinstance(x, (int, float, bool)):
        yield prefix, torch.tensor(x)


def differences(a, b, limit: int = 3) -> list:
    """[(name, [(index, a value, b value), ...])] of every leaf whose bits
    differ (a and b on any devices), with its first `limit` entries."""
    out = []
    for (name, x), (_, y) in zip(_leaves(a), _leaves(b)):
        x, y = x.detach().cpu(), y.detach().cpu()
        if x.shape != y.shape or x.dtype != y.dtype:
            out.append((name, [("shape/dtype", (x.shape, x.dtype),
                                (y.shape, y.dtype))]))
            continue
        if x.dtype.is_floating_point:
            ne = x.reshape(-1).view(torch.int32 if x.element_size() == 4
                                    else torch.int64) \
                != y.reshape(-1).view(torch.int32 if y.element_size() == 4
                                      else torch.int64)
        else:
            ne = x.reshape(-1) != y.reshape(-1)
        idx = torch.nonzero(ne)[:limit, 0].tolist()
        if idx:
            xf, yf = x.reshape(-1), y.reshape(-1)
            out.append((name, [(i, xf[i].item(), yf[i].item())
                               for i in idx]))
    return out


def _first(label: str, diffs: list) -> bool:
    if diffs:
        name, entries = diffs[0]
        print(f"  first differing value: {label}: {name} "
              f"(flat index, card, CPU) {entries}; differing leaves: "
              f"{[d[0] for d in diffs]}", flush=True)
    return bool(diffs)


def _explain_init(pc, pg, cfg):
    """The pieces of device_init, each on both devices from CPU inputs."""
    from goicp_tpu_torch.bounds.error import initial_error
    if _first("initial_error (identity error)",
              differences(initial_error(pg, cfg), initial_error(pc, cfg))):
        return
    from goicp_tpu_torch.geom.rotation import rodrigues
    K = max(1, min(int(cfg.init_seeds), len(eng._INIT_SEED_RV)))
    rv = torch.as_tensor(eng._INIT_SEED_RV[:K])
    Rc = rodrigues(rv)
    if _first("rodrigues of the ICP seeds",
              differences(rodrigues(rv.cuda()), Rc)):
        return
    z = torch.zeros((K, 3))
    if _first("seeded ICP + rescoring (R, t, score, incomp)",
              differences(eng._icp_from(pg, cfg, Rc.cuda(), z.cuda()),
                          eng._icp_from(pc, cfg, Rc, z))):
        return
    _first("the initial incumbent (the pick)",
           differences(eng._initial_incumbent(pg, cfg),
                       eng._initial_incumbent(pc, cfg)))


def _explain_step(pc, pg, cfg, s_cpu):
    """The pieces of the outer step that follows state s_cpu, each rerun on
    both devices from the CPU's inputs."""
    s_gpu = _to(s_cpu, "cuda")
    p_c, p_g = eng._pop(pc, cfg, s_cpu), eng._pop(pg, cfg, s_gpu)
    if _first("the popped lanes' rotations and rotated points",
              differences({k: p_g[k] for k in ("R_lanes", "pts")},
                          {k: p_c[k] for k in ("R_lanes", "pts")})):
        return
    rc = eng.inner_bnb(pc, cfg, p_c["pts"], p_c["widths"], p_c["active"],
                       s_cpu["opt_err"], with_rot_uncertainty=False,
                       fused=True)
    rg = eng.inner_bnb(pg, cfg, p_g["pts"], p_g["widths"], p_g["active"],
                       s_gpu["opt_err"], with_rot_uncertainty=False,
                       fused=True)
    # the card's counts are 0-d tensors (one launch, no host read), the
    # CPU's ints
    rg = rg._replace(iters=int(rg.iters), chem_corners=int(rg.chem_corners))
    if _first("the inner search (bound sums)", differences(rg, rc)):
        return
    from goicp_tpu_torch.search import pick
    ubs = torch.where(p_c["active"], rc.best_err, eng.INF)
    lane = int(torch.argmin(ubs))
    tn = rc.best_node[lane]
    args = (p_c["R_lanes"], rc.best_node, ubs, p_c["R_lanes"][lane],
            tn[:3] + tn[3] / 2.0)
    got_c = pick.refine_rows(cfg, [(0, pc, *args)], 1, "cpu")
    got_g = pick.refine_rows(cfg, [(0, pg, *_to(args, "cuda"))], 1, "cuda")
    if _first("the ICP of the best lanes, the pick and the candidate's "
              "count (the refine record)", differences(dict(got_g),
                                                        dict(got_c))):
        return
    print("  every piece agrees from the same inputs: the split is in "
          "the step's own arithmetic (adopt / merge)", flush=True)


def trace(name: str, until_split: bool = False):
    """The trace of the module's docstring."""
    torch.set_num_threads(1)
    cfg, pc = bench_pair(name, "cpu")
    _, pg = bench_pair(name, "cuda")
    d = differences(pg, pc)
    print(f"{name}: prepared pair, differing leaves (card vs CPU): "
          f"{[x[0] for x in d]}", flush=True)
    if d:
        _first("prepare_pair", d)
    sc, sg = eng.device_init(pc, cfg), eng.device_init(pg, cfg)
    first_state = None
    if differences(sg, sc):
        first_state = 0
        print(f"{name}: the initial state differs", flush=True)
        _first("device_init", differences(sg, sc))
        _explain_init(pc, pg, cfg)

    def rec(s):
        return (int(s["it"]), int(s["inner_it"]), int(s["evals"]),
                int(s["icp_runs"]), float(s["opt_err"]))
    first = {}
    while not (bool(sc["converged"]) and bool(sg["converged"])) \
            and int(sc["it"]) < cfg.max_outer_steps:
        prev = sc
        sc = eng.device_run_chunk(pc, cfg, sc, 1)
        sg = eng.device_run_chunk(pg, cfg, sg, 1)
        if first_state is None and differences(sg, sc):
            first_state = int(sc["it"])
            print(f"{name}: first state split after outer step "
                  f"{first_state}: card {rec(sg)}, CPU {rec(sc)}",
                  flush=True)
            _first("the step's state", differences(sg, sc))
            _explain_step(pc, pg, cfg, prev)
        g, c = rec(sg), rec(sc)
        for what, k in (("counters", slice(0, 4)), ("incumbent", 4)):
            if what not in first and g[k] != c[k]:
                first[what] = c[0]
                print(f"{name}: first {what} split after outer step "
                      f"{c[0]}: card {g}, CPU {c}", flush=True)
        if until_split and "counters" in first:
            break
    print(f"{name}: final (it, inner_it, evals, icp_runs, opt_err): card "
          f"{rec(sg)}, CPU {rec(sc)}; first state split: {first_state}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--write", nargs="*", metavar="NAME")
    g.add_argument("--trace", metavar="NAME")
    ap.add_argument("--until-split", action="store_true")
    a = ap.parse_args(argv)
    if a.trace:
        if not torch.cuda.is_available():
            print("--trace needs a CUDA device", file=sys.stderr)
            return 1
        trace(a.trace, a.until_split)
    else:
        write_rows(tuple(a.write) or ROW_PAIRS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
