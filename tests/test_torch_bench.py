"""The port's bench (goicp_tpu_torch/bench/measure.py): the pools'
bucketed preparation equals the JAX package's, `_check_parity` holds good
results and refuses bad ones, and `main` on the CPU writes the documented
keys (without the BO1 reference data, which a missing directory makes an
error, not a silent fallback)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from goicp_tpu.bench import measure as jmeasure
from goicp_tpu.config import GoICPConfig as JConfig
from goicp_tpu_torch.bench import measure as tmeasure
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.search.device_engine import DeviceResult
from tests.test_torch_prepare import _assert_same

torch.set_num_threads(1)


def _cfgs(**kw):
    return (tmeasure.bench_shape(GoICPConfig(**kw)),
            jmeasure.bench_shape(JConfig(**kw)))


@pytest.mark.parametrize("max_buckets", [1, 2])
def test_similar_buckets_equal_jax(max_buckets):
    cfg, jcfg = _cfgs()
    got = tmeasure.build_batch_buckets(cfg, 4, max_buckets, device="cpu")
    want = jmeasure._bucket_and_prepare_multi(
        [jmeasure._normalized_synthetic(e)
         for e in jmeasure.synthetic_pool(4)], jcfg, max_buckets)
    assert [idxs for _, idxs in got] == [idxs for _, idxs in want]
    for (tps, _), (jps, _) in zip(got, want):
        for tp, jp in zip(tps, jps):
            _assert_same(tp, jp)
    assert tmeasure.similar_names(4) == ["syn00", "syn01", "syn02", "syn03"]
    assert tmeasure.similar_names(4, "any")[:2] == list(tmeasure.REAL_NAMES)


def test_trimmed_buckets_equal_jax():
    cfg, jcfg = _cfgs(trimFraction=tmeasure.TRIM_FRACTION,
                      trans_capacity=256)
    got = tmeasure.build_trimmed_batch_buckets(cfg, 4, device="cpu")
    want = jmeasure.build_trimmed_batch_buckets(jcfg, 4)
    assert [idxs for _, idxs in got] == [idxs for _, idxs in want]
    for (tps, _), (jps, _) in zip(got, want):
        for tp, jp in zip(tps, jps):
            _assert_same(tp, jp)
    for tp, jp in zip(tmeasure.build_trimmed_batch(cfg, 4, device="cpu"),
                      jmeasure.build_trimmed_batch(jcfg, 4)):
        _assert_same(tp, jp)


@pytest.fixture(scope="module")
def pool():
    """Four prepared similar pairs and results that pass every check: the
    fp32 reference rows' errors and counters."""
    cfg, _ = _cfgs()
    pairs = tmeasure.build_batch(cfg, 4, device="cpu")
    names = tmeasure.similar_names(4)
    rows = tmeasure.reference_rows()
    sweep = [rows[n] for n in names]
    out = DeviceResult(
        error=np.array([s["error"] for s in sweep], np.float32),
        R=np.tile(np.eye(3, dtype=np.float32), (4, 1, 1)),
        t=np.zeros((4, 3), np.float32), opt_comp=np.zeros(4, np.int32),
        terms=np.zeros((4, 3), np.float32), last_icp=np.ones(4, bool),
        outer_iters=np.array([s["outer"] for s in sweep]),
        evals=np.array([s["evals"] for s in sweep]),
        gap=np.zeros(4, np.float32), converged=np.ones(4, bool),
        inner_iters=np.array([s["inner"] for s in sweep]),
        icp_runs=np.array([s["icp_runs"] for s in sweep]))
    return cfg, pairs, names, rows, out


def _bad(out, field, i, value):
    col = np.array(getattr(out, field))
    col[i] = value
    return out._replace(**{field: col})


def test_check_parity_passes_good_results(pool):
    cfg, pairs, names, rows, out = pool
    tmeasure._check_parity(out, cfg, pairs, names, rows)
    tmeasure._check_parity(out, cfg, pairs, names)


@pytest.mark.parametrize("field,value,what", [
    ("converged", False, "unconverged"),
    ("gap", 10.0, "margin guard"),
    ("error", 0.5, "reference row"),
    ("evals", 1, "reference row"),
    ("inner_iters", 0, "reference row"),
])
def test_check_parity_refuses(pool, field, value, what):
    cfg, pairs, names, rows, out = pool
    with pytest.raises(AssertionError, match=what):
        tmeasure._check_parity(_bad(out, field, 1, value), cfg, pairs, names,
                               rows)


def test_reference_rows_cover_the_bench_pools_and_name_sweep_differences(
        pool):
    """The fp32 rows hold all 96 bench pairs; where a sweep383 row (a TPU
    run) has other counters, sweep_row_differences names the pair and the
    counters."""
    _, _, names, rows, out = pool
    assert set(rows) == {f"syn{i:02d}" for i in range(64)} | \
        {f"trm{i:02d}" for i in range(32)}
    sweep = tmeasure.sweep_rows()
    diff = tmeasure.sweep_row_differences(out, names, sweep)
    assert diff == {"syn02": {"evals": (2530736, 2530720),
                              "icp_runs": (10, 9)}}
    assert tmeasure.sweep_row_differences(
        out, names, {n: rows[n] for n in names}) == {}


def test_check_parity_golden_pair_one(pool):
    """With the reference data the pool starts with BO1 pair 1: its error
    within MSEThresh*Nd of 8.45388 and its compatibilities within 2 of
    133."""
    cfg, pairs, _, _, out = pool
    names = list(tmeasure.REAL_NAMES) + ["syn00", "syn01"]
    nd = int(pairs[0].counts[0])
    good = _bad(_bad(out, "error", 0, tmeasure.GOLDEN_ERROR + 0.5),
                "opt_comp", 0, nd - 134)
    tmeasure._check_parity(good, cfg, pairs, names)
    for field, value in (("error", tmeasure.GOLDEN_ERROR + 0.011 * nd),
                         ("opt_comp", nd - 130)):
        with pytest.raises(AssertionError, match="pair-1"):
            tmeasure._check_parity(_bad(good, field, 0, value), cfg, pairs,
                                   names)
    # without a margin the guard does not apply
    tmeasure._check_parity(_bad(good, "gap", 1, 10.0),
                           dataclasses.replace(cfg, margin_frac=1.0), pairs,
                           names)


def test_main_on_the_cpu_without_reference(tmp_path):
    path = tmp_path / "bench.json"
    got = tmeasure.main(str(path), ref_dir=None, device="cpu")
    with open(path) as fh:
        assert json.load(fh) == got
    assert set(got) == {"platform", "real_pairs", "pairs_per_s",
                        "bound_evals_per_s", "wall_s", "batch",
                        "distinct_pairs"}
    assert (got["platform"], got["real_pairs"], got["batch"],
            got["distinct_pairs"]) == ("cpu", 0, 3, 1)
    assert got["pairs_per_s"] > 0 and got["bound_evals_per_s"] > 0


def test_main_refuses_a_missing_reference(tmp_path):
    with pytest.raises(FileNotFoundError, match="--no-reference"):
        tmeasure.main(str(tmp_path / "b.json"),
                      ref_dir=str(tmp_path / "absent"), device="cpu")
    assert not (tmp_path / "b.json").exists()
