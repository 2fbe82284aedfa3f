"""The port's multi-GPU search engines on one pair (goicp_tpu_torch/
search/device_engine.py::register_device(mesh=), search/sharded_engine.py)
against the JAX package's and the port's unsharded register_device: eight
gloo ranks on the CPU (dist/spawn.run_ranks; their side is
tests/_torch_ranks.py::sharded_ranks, each row of a mesh running its own
search), JAX on conftest's 8 virtual devices, the same numpy clouds on both
sides.  The cases are tests/test_sharded_engine.py's and
tests/test_sharded_rebalance.py's.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from goicp_tpu.config import GoICPConfig as JaxConfig
from goicp_tpu.dist.mesh import make_mesh as jax_mesh
from goicp_tpu.pipeline.prepare import prepare_pair as jax_prepare
from goicp_tpu.search.device_engine import register_device as jax_register
from goicp_tpu.search.sharded_engine import \
    register_device_sharded as jax_sharded
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.dist.spawn import run_ranks
from goicp_tpu_torch.pipeline.prepare import prepare_pair
from goicp_tpu_torch.search.device_engine import register_device
from tests._torch_ranks import (LANE_CFG, PAD, SHARDED_CASES, SHARDED_CFG,
                                noisy_clouds, sharded_case)

# The port's CPU search is a loop of small torch ops; intra-op threads only
# contend with the parallel test workers.  One thread gives the same results.
torch.set_num_threads(1)

_COUNTERS = ("outer_iters", "evals", "inner_iters", "icp_runs", "opt_comp",
             "geom_surv", "chem_corners", "converged", "last_icp")


@pytest.fixture(scope="module")
def ranks():
    """The eight ranks' results (a Future: JAX computes beside them)."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_ranks, "tests._torch_ranks:sharded_ranks", 8,
                      device="cpu", timeout_s=400)
    yield fut
    pool.shutdown()


def _run(outs, key, ranks_of_row):
    """The run `key` as every rank of its mesh row returned it (all equal)
    -> {field: value}."""
    fields = [f for f in outs[ranks_of_row[0]] if f.startswith(key + ".")]
    for r in ranks_of_row[1:]:
        for f in fields:
            np.testing.assert_array_equal(outs[r][f],
                                          outs[ranks_of_row[0]][f], f)
    return {f[len(key) + 1:]: outs[ranks_of_row[0]][f] for f in fields}


def _eps(cfg, pair) -> float:
    return cfg.MSEThresh * pair.inlier_num + 1e-5


def test_register_device_lane_sharded(ranks):
    """The lanes of each outer step split over 4 ranks: every counter and
    value equal to the port's unsharded register_device, except
    chem_corners, which counts the corners evaluated (with lane compaction
    each rank's stages are narrower: 1,630,044 against 1,956,528 on this
    pair, the same in JAX); every counter equal to JAX's lane-sharded
    register_device on a 1 x 4 mesh, chem_corners included."""
    data, model, dp, mp = noisy_clouds(11, 0.02)
    jcfg = JaxConfig(**LANE_CFG)
    want = jax.device_get(register_jax_lanes(
        jax_prepare(data, model, dp, mp, jcfg, **PAD), jcfg))
    cfg = GoICPConfig(**LANE_CFG)
    plain = register_device(prepare_pair(data, model, dp, mp, cfg, **PAD,
                                         device="cpu"), cfg)
    got = _run(ranks.result(), "lane", range(4))
    assert bool(got["converged"]) and int(got["outer_iters"]) > 100
    for f in _COUNTERS:
        assert int(got[f]) == int(getattr(want, f)), f
        if f != "chem_corners":
            assert int(got[f]) == int(getattr(plain, f)), f
    assert int(got["chem_corners"]) != int(plain.chem_corners)
    for f in ("error", "R", "t", "gap", "terms"):
        np.testing.assert_array_equal(got[f], getattr(plain, f).numpy(), f)
        np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def register_jax_lanes(pair, cfg):
    return jax_register(pair, cfg, mesh=jax_mesh(n_data=1, n_search=4))


def test_sharded_matches_jax_and_unsharded_optimum(ranks):
    """Per-rank frontiers over 4 ranks, rebalanced every step, against
    JAX's register_device_sharded on a 1 x 4 mesh: converged, error within
    eps of JAX's and of the port's unsharded register_device, gap <= eps,
    and outer and inner iterations and survivors equal.  evals and
    icp_runs differ a little: the trajectories split where the unsharded
    engines of the two packages split too (at outer step 247 a lane's ub,
    a float32 sum taken in another order, differs by one ulp, and 8 more
    bound evaluations follow)."""
    cfg, pair = sharded_case("optimum", "cpu")
    over, seed, noise = SHARDED_CASES["optimum"]
    jcfg = JaxConfig(**dict(SHARDED_CFG, **over))
    want = jax.device_get(jax_sharded(
        jax_prepare(*noisy_clouds(seed, noise), jcfg, **PAD), jcfg,
        jax_mesh(n_data=1, n_search=4), rebalance_every=1))
    plain = register_device(pair, cfg)
    got = _run(ranks.result(), "optimum1", range(4, 8))
    eps = _eps(cfg, pair)
    assert bool(got["converged"]) and bool(want.converged)
    assert abs(float(got["error"]) - float(want.error)) <= eps
    assert abs(float(got["error"]) - float(plain.error)) <= eps
    assert float(got["gap"]) <= eps
    for f in ("outer_iters", "inner_iters", "geom_surv", "opt_comp"):
        assert int(got[f]) == int(getattr(want, f)), f
    assert abs(int(got["evals"]) - int(want.evals)) <= 16
    assert abs(int(got["icp_runs"]) - int(want.icp_runs)) <= 1


def test_rebalance_reduces_steps_on_skew(ranks):
    """Static subtree partitioning (rebalance_every=0) against rebalancing
    every 2 steps, 4 ranks each: the same optimum, fewer lockstep outer
    steps with the rebalance."""
    cfg, pair = sharded_case("skew", "cpu")
    outs = ranks.result()
    static = _run(outs, "skew0", range(4))
    rebal = _run(outs, "skew2", range(4, 8))
    eps = _eps(cfg, pair)
    assert bool(static["converged"]) and bool(rebal["converged"])
    assert abs(float(static["error"]) - float(rebal["error"])) <= eps
    assert int(rebal["outer_iters"]) < int(static["outer_iters"]), \
        (int(rebal["outer_iters"]), int(static["outer_iters"]))


def test_rebalance_cadences_agree(ranks):
    """Rebalancing every 1 and every 4 steps, 2 ranks each, land on the
    same optimum (the cadence is a performance knob)."""
    cfg, pair = sharded_case("cadences", "cpu")
    outs = ranks.result()
    runs = [_run(outs, "cadences1", [0, 1]), _run(outs, "cadences4", [2, 3])]
    for r in runs:
        assert bool(r["converged"]) and float(r["gap"]) <= _eps(cfg, pair)
    assert abs(float(runs[0]["error"]) - float(runs[1]["error"])) \
        <= _eps(cfg, pair)
