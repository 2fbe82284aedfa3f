"""The port's device mesh on torch.distributed (goicp_tpu_torch/dist/
mesh.py, dist/dryrun.py) against the JAX package's (goicp_tpu/dist/mesh.py):
four gloo ranks on the CPU (dist/spawn.run_ranks; their side is
tests/_torch_ranks.py::dist_ranks) against JAX on conftest's 8 virtual
devices, the same numpy inputs on both sides.  sharded_inner_step at the
layouts (1, 2), (2, 2) and (2, 1): every rank of the mesh holds the whole
result, equal to the port's own inner_bnb pair by pair (the sharding moves
no bit), and to JAX's in best_err and lb_safe to rtol 1e-6 (the bound sums
are float32 taken in another order: on the second pair a few lanes' ubs
differ by one ulp, and their best nodes then differ too) and in its
iteration, evaluation and survivor counts; put_global and reduce_best on
a 2 x 2 mesh; dryrun_multichip(4).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goicp_tpu.config import GoICPConfig as JaxConfig
from goicp_tpu.dist.mesh import make_mesh as jax_mesh
from goicp_tpu.dist.mesh import sharded_inner_step as jax_inner_step
from goicp_tpu.dist.mesh import stack_pairs as jax_stack
from goicp_tpu.pipeline.prepare import prepare_pair as jax_prepare
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.dist.dryrun import _tiny_cfg, _tiny_pair
from goicp_tpu_torch.dist.spawn import run_ranks
from goicp_tpu_torch.pipeline.prepare import prepare_pair
from goicp_tpu_torch.search.device_engine import register_device_batch
from goicp_tpu_torch.search.inner import inner_bnb
from tests._torch_ranks import (INNER_CFG, INNER_LAYOUTS, inner_clouds,
                                inner_inputs)

# The port's CPU search is a loop of small torch ops; intra-op threads only
# contend with the parallel test workers.  One thread gives the same results.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks():
    """The four ranks' results (a Future: JAX computes beside them)."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_ranks, "tests._torch_ranks:dist_ranks", 4,
                      device="cpu", timeout_s=300)
    yield fut
    pool.shutdown()


@pytest.mark.parametrize("layout", INNER_LAYOUTS,
                         ids=[f"{d}x{s}" for d, s in INNER_LAYOUTS])
def test_sharded_inner_step_matches_jax(ranks, layout):
    n_data, n_search = layout
    assert len(jax.devices()) >= 8
    cfg = JaxConfig(**INNER_CFG)
    pairs = [jax_prepare(d, m, p, p, cfg, pad_cells=24, pad_points=8)
             for d, m, p in map(inner_clouds, range(n_data))]
    inputs = inner_inputs(n_data)
    mesh = jax_mesh(n_data=n_data, n_search=n_search)
    with mesh:
        want = jax.device_get(jax_inner_step(
            mesh, cfg, with_rot_uncertainty=False)(
                jax_stack(pairs), *map(jnp.asarray, inputs)))
    tcfg = GoICPConfig(**INNER_CFG)
    port = []
    for b, (d, m, p) in enumerate(map(inner_clouds, range(n_data))):
        pair = prepare_pair(d, m, p, p, tcfg, pad_cells=24, pad_points=8,
                            device="cpu")
        port.append(inner_bnb(pair, tcfg, *(torch.as_tensor(a[b])
                                            for a in inputs),
                              with_rot_uncertainty=False))
    tag = f"inner{n_data}x{n_search}"
    for rank, out in enumerate(ranks.result()[:n_data * n_search]):
        for f in port[0]._fields:
            np.testing.assert_array_equal(
                out[f"{tag}.{f}"],
                np.stack([torch.as_tensor(getattr(r, f)).numpy()
                          for r in port]), f"rank {rank} {f}")
        for f in ("best_err", "lb_safe"):
            np.testing.assert_allclose(out[f"{tag}.{f}"],
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-6, err_msg=f"rank {rank} {f}")
        for f in ("iters", "evals", "geom_surv"):
            np.testing.assert_array_equal(out[f"{tag}.{f}"],
                                          np.asarray(getattr(want, f)),
                                          f"rank {rank} {f}")


def test_reduce_best(ranks):
    """reduce_best is the minimum over the ranks of one mesh axis: on a
    2 x 2 mesh, rank g sits at (g // 2, g % 2)."""
    outs = ranks.result()
    errs = [out["errs"] for out in outs]
    for g, out in enumerate(outs):
        d, s = divmod(g, 2)
        assert out["best_search"] == min(errs[2 * d].min(),
                                         errs[2 * d + 1].min())
        assert out["best_data"] == min(errs[s].min(), errs[2 + s].min())


def test_put_global(ranks):
    """put_global takes this rank's block of the pair axis (split over
    `data`; the search ranks of a data row hold the same block), of a
    tensor and of a stacked PairData."""
    tcfg = GoICPConfig(**INNER_CFG)
    data = [prepare_pair(d, m, p, p, tcfg, pad_cells=24, pad_points=8,
                         device="cpu").data.numpy()
            for d, m, p in map(inner_clouds, range(2))]
    for g, out in enumerate(ranks.result()):
        d = g // 2
        np.testing.assert_array_equal(out["put_rows"],
                                      np.arange(8).reshape(4, 2)[2 * d:
                                                                 2 * d + 2])
        np.testing.assert_array_equal(out["put_pairs"], data[d][None])


def test_dryrun_multichip_4(ranks):
    outs = ranks.result()
    cfg = _tiny_cfg()
    pairs = [_tiny_pair(cfg, "cpu", seed=s) for s in range(4)]
    unsharded = register_device_batch(pairs, cfg).error
    for rank, out in enumerate(outs):
        assert int(out["dryrun.n_data"]) == 2
        assert int(out["dryrun.n_search"]) == 2
        for k in ("batch", "lane", "sharded", "stream", "handoff"):
            v = out[f"dryrun.{k}"]
            assert np.isfinite(v).all(), (rank, k)
            np.testing.assert_array_equal(v, outs[0][f"dryrun.{k}"])
        np.testing.assert_array_equal(out["dryrun.batch"], unsharded)
