"""The port's helpers off the search path vs the JAX package's:
chem/extras.py (each function on the same seeded inputs),
utils/profiling.py (PhaseTimers, and trace over torch.profiler) and
pipeline/visualize.py (plot_registration)."""

import json
import os

import numpy as np
import pytest

from goicp_tpu.chem import extras as jx
from goicp_tpu.pipeline.visualize import plot_registration as jplot
from goicp_tpu.utils.profiling import PhaseTimers as JTimers
from goicp_tpu_torch.chem import extras as tx
from goicp_tpu_torch.pipeline.visualize import plot_registration
from goicp_tpu_torch.utils.profiling import PhaseTimers, trace


def _clouds(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 0.05, size=(20, 3))
    coords = np.vstack([a, a + 50.0, rng.normal(size=(24, 3)) * 0.1])
    props = rng.integers(1, 4, size=len(coords))
    return rng, coords, props


@pytest.mark.parametrize("seed", [0, 1])
def test_extras_equal_jax(seed):
    rng, coords, props = _clouds(seed)
    np.testing.assert_array_equal(tx.property_density(coords, props),
                                  jx.property_density(coords, props))
    src_d = rng.uniform(0, 1, 30).astype(np.float32)
    tgt_d = rng.uniform(0, 1, 40).astype(np.float32)
    nn = rng.integers(0, 40, 30)
    np.testing.assert_array_equal(
        tx.density_difference_icp(src_d, tgt_d, nn),
        jx.density_difference_icp(src_d, tgt_d, nn))
    cell_points = rng.integers(-1, 40, size=(12, 5))
    cell_points[3] = -1                      # an empty cell: minD's 100
    cell_ids = rng.integers(0, 12, 30)
    np.testing.assert_array_equal(
        tx.density_difference_bnb(src_d, tgt_d, cell_points, cell_ids),
        jx.density_difference_bnb(src_d, tgt_d, cell_points, cell_ids))
    a, b = rng.integers(0, 12, 50), rng.integers(0, 12, 50)
    assert tx.neighbor_mismatch_v2(a, b) == jx.neighbor_mismatch_v2(a, b)
    assert tx.neighbor_mismatch_v3(a, b) == jx.neighbor_mismatch_v3(a, b)
    assert tx.neighbor_mismatch_v3([1, 1, 3, 6, 9], [4, 6, 7, 0, 0]) == 6
    pts = rng.normal(size=(200, 3)) * np.array([5.0, 3.0, 0.01])
    np.testing.assert_array_equal(tx.covariance_matrix(pts),
                                  jx.covariance_matrix(pts))
    assert tx.eigen_shape_features(pts) == jx.eigen_shape_features(pts)


def test_phase_timers_sum():
    t, j = PhaseTimers(), JTimers()
    for timers in (t, j):
        for name in ("a", "b", "a"):
            with timers.phase(name):
                sum(range(1000))
    s = t.summary()
    assert set(s) == set(j.summary()) == {"a", "b"}
    assert s["a"]["calls"] == 2 and s["b"]["calls"] == 1
    assert t.totals["a"] >= 0.0 and s["a"]["total_s"] == round(t.totals["a"],
                                                               4)
    with pytest.raises(ValueError):
        with t.phase("c"):
            raise ValueError("a failing phase is still timed")
    assert t.counts["c"] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch
    with trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert prof is not None
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as fh:
        assert "traceEvents" in json.load(fh)
    with trace(None) as prof:
        pass
    assert prof is None


def test_plot_registration_returns_a_bool(tmp_path):
    rng = np.random.default_rng(3)
    model = rng.uniform(-1, 1, (30, 3))
    data = model[:20] @ np.eye(3)
    out = str(tmp_path / "reg.png")
    got = plot_registration(model, data, np.eye(3), np.zeros(3), out)
    assert got == jplot(model, data, np.eye(3), np.zeros(3),
                        str(tmp_path / "jax.png"))
    assert isinstance(got, bool) and os.path.exists(out) == got
