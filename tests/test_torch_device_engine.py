"""Port registration engine (goicp_tpu_torch/search/device_engine.py) vs the
JAX register_device on the same prepared pair: DeviceResult counters equal,
error, R and t within 1e-5.  Also two bench pairs at the bench's search
shape, held against the JAX package, the fp32 reference rows the on-card
smoke run checks (goicp_tpu_torch/bench/reference_rows.jsonl) and their
sweep383*.jsonl rows.

    python tests/test_torch_device_engine.py --write-rows

regenerates the reference rows of all 96 bench pairs (syn00-syn63,
trm00-trm31) with the JAX package on the CPU (~25 min in one process), and
then the rows of the fork's error options
(goicp_tpu_torch/bench/option_rows.jsonl: each option of
goicp_tpu_torch/bench/options.py on its six pairs, and the host engine on
its first pair, ~5 min).

    python tests/test_torch_device_engine.py --write-sweep-rows

writes the fp32 rows of the next pairs by index, syn64-syn79 and
trm32-trm39 (goicp_tpu_torch/bench/sweep_rows_fp32.jsonl, ~20 min; syn72's
13,047 inner iterations are most of it), which the port's sweep383 holds
its pools to beside the bench rows.

    python tests/test_torch_device_engine.py --trace-steps syn72

steps the JAX and the port's register_device on a bench pair one outer
step at a time on the CPU and prints the first step whose counters or
incumbent differ in the two packages, and each package's final counters
(syn72: ~1 min for JAX, ~7 min for the port).
"""

import dataclasses
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from goicp_tpu.bench import measure as jmeasure  # noqa: E402
from goicp_tpu.bounds.error import score_transform  # noqa: E402
from goicp_tpu.config import GoICPConfig  # noqa: E402
from goicp_tpu.icp.icp import nn_correspondences  # noqa: E402
from goicp_tpu.pipeline import prepare as jprep  # noqa: E402
from goicp_tpu.search import device_engine as jeng  # noqa: E402
from goicp_tpu.search import outer as jouter  # noqa: E402
from goicp_tpu_torch import config as tconfig  # noqa: E402
from goicp_tpu_torch.bench import options  # noqa: E402
from goicp_tpu_torch.pipeline import prepare as tprep  # noqa: E402
from goicp_tpu_torch.search import device_engine as teng  # noqa: E402
from tests.test_device_engine import _cfg, _pair  # noqa: E402

# The port's CPU search is a loop of small torch ops. Intra-op threads only
# contend with the parallel test workers (a case ran ~25x slower beside
# them); one thread gives the same results.
torch.set_num_threads(1)

ROWS = REPO / "goicp_tpu_torch" / "bench" / "reference_rows.jsonl"
BENCH_PAIRS = [f"syn{i:02d}" for i in range(64)] + \
    [f"trm{i:02d}" for i in range(32)]
SWEEP_ROWS = REPO / "goicp_tpu_torch" / "bench" / "sweep_rows_fp32.jsonl"
SWEEP_PAIRS = [f"syn{i:02d}" for i in range(64, 80)] + \
    [f"trm{i:02d}" for i in range(32, 40)]
_COUNTERS = ("outer_iters", "evals", "inner_iters", "icp_runs", "opt_comp",
             "geom_surv", "chem_corners", "converged", "last_icp")


def _port_cfg(cfg):
    """The port's own GoICPConfig with the same values (the JAX fields the
    port lacks belong to unported modules and leave register_device alone)."""
    return tconfig.GoICPConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(tconfig.GoICPConfig)})


def _assert_same(got, want):
    for f in _COUNTERS:
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    for f in ("error", "R", "t", "gap", "terms"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


_CHEM = dict(regularization=0.0005, ponderation=1, distTransSize=16)


@pytest.mark.parametrize("name,kw,pad,seed", [
    # MSEThresh 0.005: the same 112 outer steps as _cfg's 0.001, with
    # 105,448 bound evaluations instead of 1.6 M
    ("plain", dict(MSEThresh=0.005), False, 1),
    ("chem", dict(MSEThresh=0.05, **_CHEM), False, 3),
    ("chem_reuse_padded", dict(MSEThresh=0.05, chem_reuse=1, rot_batch=2,
                               **_CHEM), True, 3),
    ("trimmed_dynamic", dict(MSEThresh=0.03, trimFraction=0.05,
                             chem_reuse=1, **_CHEM), True, 1),
])
def test_register_device_matches_jax(name, kw, pad, seed):
    cfg = _cfg(**kw)
    jp, _, _ = _pair(cfg, seed=seed, pad=pad)
    if pad:
        jp = jprep.make_count_dynamic(jp)
    want = jax.device_get(jeng.register_device(jp, cfg))
    got = teng.register_device(tprep.pair_from_jax(jp, "cpu"), _port_cfg(cfg))
    assert bool(got.converged)
    _assert_same(got, want)


def _bench(name, option=None):
    """(cfg, JAX pair, raw inputs) of a bench pair under GoICPConfig() +
    bench_shape, or under one of the fork's error options (then the raw
    inputs end with the pair's seeded c-FPFH descriptors)."""
    cfg = jmeasure.bench_shape(GoICPConfig())
    trimmed = name.startswith("trm")
    if option is not None:
        cfg = options.option_config(cfg, option, trimmed=trimmed)
    elif trimmed:
        cfg = dataclasses.replace(cfg, trimFraction=jmeasure.TRIM_FRACTION,
                                  trans_capacity=256)
    # both draws are prefix-stable: a pool of index + 1 pairs holds the pair
    n = int(name[3:]) + 1
    pool = jmeasure.synthetic_pool_trimmed(n, seed=23) if trimmed \
        else jmeasure.synthetic_pool(n, seed=7)
    entry = next(e for e in pool if e[0] == name)
    raw = jmeasure._normalized_synthetic(entry)
    if option is not None:
        raw = raw + options.seeded_descriptors(raw[2], raw[3])
    jp = jprep.make_count_dynamic(
        jprep.prepare_pair(*raw[:4], cfg, *raw[4:], bucket=True))
    return cfg, jp, raw


def _row(r):
    return dict(error=float(r.error), converged=bool(r.converged),
                outer=int(r.outer_iters), inner=int(r.inner_iters),
                evals=int(r.evals), icp_runs=int(r.icp_runs))


def _sweep_row(name):
    path = REPO / ("sweep383_trimmed.jsonl" if name.startswith("trm")
                   else "sweep383.jsonl")
    with open(path) as fh:
        return next(r for r in map(json.loads, fh) if r["pair"] == name)


@pytest.mark.parametrize("name", ["syn13", "trm13"])
def test_bench_pair_matches_jax_and_rows(name):
    cfg, jp, raw = _bench(name)
    want = jax.device_get(jeng.register_device(jp, cfg))
    # the port's own preparation, not a copy of the JAX pair
    tcfg = _port_cfg(cfg)
    tp = tprep.make_count_dynamic(tprep.prepare_pair(*raw, tcfg, bucket=True,
                                                     device="cpu"))
    got = teng.register_device(tp, tcfg)
    _assert_same(got, want)
    with open(ROWS) as fh:
        ref = next(r for r in map(json.loads, fh) if r["pair"] == name)
    jrow = _row(want)
    assert {k: v for k, v in jrow.items() if k != "error"} == \
        {k: v for k, v in ref.items() if k not in ("pair", "error")}
    assert abs(jrow["error"] - ref["error"]) <= 1e-5
    sweep = _sweep_row(name)
    if name == "syn13":
        # the similar pool's search counters reproduce the TPU sweep row;
        # its error does not (the row's 0.69843 is a TPU-precision score,
        # the fp32 rescore of the recovered transform is 0)
        for k in ("outer", "inner", "evals", "icp_runs", "converged"):
            assert jrow[k] == sweep[k], k
    else:
        # trm13's TPU row (120 evals) is not reproduced by the JAX package
        # on the CPU (64 evals); both packages agree with each other
        assert jrow["converged"] and sweep["converged"]


def option_row(option, name, cfg, jp, r):
    """A row of option_rows.jsonl: the search's result (its terms as the
    engine carries them: geom, incomp + nbr, fpfh) and the final transform
    rescored (score_transform with its nearest-neighbour correspondences)
    into its four terms."""
    R, t = jax.numpy.asarray(r.R), jax.numpy.asarray(r.t)
    nn, _ = nn_correspondences(jp.data @ R.T + t, jp.model)
    sc = score_transform(jp, cfg, R, t, nn)
    return {"option": option, "pair": name, **_row(r),
            "terms": [float(x) for x in np.asarray(r.terms)],
            "compat": int(r.opt_comp),
            "score": {k: float(getattr(sc, k)) for k in
                      ("error", "geom", "incomp_term", "fpfh_term",
                       "nbr_term")}}


def write_rows(path=ROWS, names=BENCH_PAIRS):
    with open(path, "w") as fh:
        for name in names:
            cfg, jp, _ = _bench(name)
            row = _row(jax.device_get(jeng.register_device(jp, cfg)))
            fh.write(json.dumps({"pair": name, **row}) + "\n")
            # every pair compiles its own programs; kept, they exhaust
            # XLA:CPU's memory for compiled code within one process
            jax.clear_caches()


def host_row(cfg, raw):
    """The JAX host engine's result on the unpadded pair: its counters,
    error and error terms."""
    h = jouter.register(jprep.prepare_pair(*raw[:4], cfg, *raw[4:]), cfg)
    return {"error": float(h.error), "geom_error": float(h.geom_error),
            "incomp_error": float(h.incomp_error),
            "fpfh_error": float(h.fpfh_error), "converged": bool(h.converged),
            "last_icp": bool(h.last_icp), "outer_steps": int(h.outer_steps),
            "bound_evals": int(h.bound_evals), "icp_runs": int(h.icp_runs),
            "optComp": int(h.optComp)}


def write_option_rows():
    """Every (option, pair)'s register_device row; the first pair of each
    option also carries the host engine's result under "host"."""
    with open(options.OPTION_ROWS, "w") as fh:
        for option, names in options.OPTION_PAIRS.items():
            for name in names:
                cfg, jp, raw = _bench(name, option)
                r = jax.device_get(jeng.register_device(jp, cfg))
                row = option_row(option, name, cfg, jp, r)
                if name == names[0]:
                    row["host"] = host_row(cfg, raw)
                fh.write(json.dumps(row) + "\n")
                jax.clear_caches()


def trace_steps(name):
    """Both packages' register_device on one bench pair, an outer step at
    a time: (it, inner_it, evals, icp_runs, opt_err) after each step."""
    cfg, jp, _ = _bench(name)
    tcfg = _port_cfg(cfg)
    tp = tprep.pair_from_jax(jp, "cpu")
    run = jax.jit(jeng.device_run_chunk, static_argnames=("cfg", "mesh"))
    js = jax.jit(jeng.device_init, static_argnames=("cfg",))(jp, cfg)
    ts = teng.device_init(tp, tcfg)

    def rec(s):
        return (int(s["it"]), int(s["inner_it"]), int(s["evals"]),
                int(s["icp_runs"]), float(s["opt_err"]))

    def done(s):
        return bool(s["converged"]) or int(s["it"]) >= cfg.max_outer_steps
    first = {}
    while not (done(js) and done(ts)):
        if not done(js):
            js = run(jp, cfg, js, np.int32(1))
        if not done(ts):
            ts = teng.device_run_chunk(tp, tcfg, ts, 1)
        j, t = rec(js), rec(ts)
        for what, k in (("counters", slice(0, 4)), ("incumbent", 4)):
            if what not in first and j[k] != t[k]:
                first[what] = (j, t)
                print(f"{name}: first {what} split after outer step "
                      f"{j[0]}: JAX {j}, port {t}", flush=True)
    print(f"{name}: final (it, inner_it, evals, icp_runs, opt_err): JAX "
          f"{rec(js)}, port {rec(ts)}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-rows"]:
        jax.config.update("jax_platforms", "cpu")
        write_rows()
        write_option_rows()
    elif sys.argv[1:] == ["--write-sweep-rows"]:
        jax.config.update("jax_platforms", "cpu")
        write_rows(SWEEP_ROWS, SWEEP_PAIRS)
    elif sys.argv[1:2] == ["--trace-steps"]:
        jax.config.update("jax_platforms", "cpu")
        torch.set_num_threads(1)
        trace_steps(sys.argv[2])
