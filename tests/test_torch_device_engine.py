"""Port registration engine (goicp_tpu_torch/search/device_engine.py) vs the
JAX register_device on the same prepared pair: DeviceResult counters equal,
error, R and t within 1e-5.  Also two bench pairs at the bench's search
shape, held against the JAX package, the fp32 reference rows the on-card
smoke run checks (goicp_tpu_torch/bench/reference_rows.jsonl) and their
sweep383*.jsonl rows.

    python tests/test_torch_device_engine.py --write-rows

regenerates the reference rows of all 96 bench pairs (syn00-syn63,
trm00-trm31) with the JAX package on the CPU (~15 min in one process).
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
from goicp_tpu.config import GoICPConfig  # noqa: E402
from goicp_tpu.pipeline import prepare as jprep  # noqa: E402
from goicp_tpu.search import device_engine as jeng  # noqa: E402
from goicp_tpu_torch import config as tconfig  # noqa: E402
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


def _bench(name):
    cfg = jmeasure.bench_shape(GoICPConfig())
    if name.startswith("trm"):
        cfg = dataclasses.replace(cfg, trimFraction=jmeasure.TRIM_FRACTION,
                                  trans_capacity=256)
        pool = jmeasure.synthetic_pool_trimmed(32, seed=23)
    else:
        pool = jmeasure.synthetic_pool(64, seed=7)
    entry = next(e for e in pool if e[0] == name)
    data, model, dp, mp = jmeasure._normalized_synthetic(entry)
    jp = jprep.make_count_dynamic(
        jprep.prepare_pair(data, model, dp, mp, cfg, bucket=True))
    return cfg, jp, (data, model, dp, mp)


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


def write_rows():
    with open(ROWS, "w") as fh:
        for name in BENCH_PAIRS:
            cfg, jp, _ = _bench(name)
            row = _row(jax.device_get(jeng.register_device(jp, cfg)))
            fh.write(json.dumps({"pair": name, **row}) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-rows"]:
        jax.config.update("jax_platforms", "cpu")
        write_rows()
