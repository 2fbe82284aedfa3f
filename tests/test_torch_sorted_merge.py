"""The port's sorted two-way rank merge (cfg.sorted_merge,
goicp_tpu_torch/search/inner.py::_merge_sorted_keep) vs the JAX package's
on the same inputs (kept lbs and nodes in order, dropped lbs), and the
device engine with sorted_merge=1 vs sorted_merge=0 and vs the JAX
package's (identical trajectories)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goicp_tpu.search import device_engine as jeng
from goicp_tpu.search.inner import _merge_sorted_keep as jmerge
from goicp_tpu_torch.pipeline.prepare import pair_from_jax
from goicp_tpu_torch.search import device_engine as teng
from goicp_tpu_torch.search.inner import _merge_sorted_keep as tmerge
from tests.test_device_engine import _cfg, _pair
from tests.test_torch_device_engine import _port_cfg

torch.set_num_threads(1)


def _both(rest_lbs, new_lbs, cap, K=4):
    L, R = rest_lbs.shape
    B = new_lbs.shape[1]
    rest_nodes = np.arange(L * R * K, dtype=np.float32).reshape(L, R, K)
    new_nodes = -1 - np.arange(L * B * K, dtype=np.float32).reshape(L, B, K)
    want = jmerge(jnp.asarray(rest_lbs), jnp.asarray(rest_nodes),
                  jnp.asarray(new_lbs), jnp.asarray(new_nodes), cap)
    got = tmerge(torch.as_tensor(rest_lbs), torch.as_tensor(rest_nodes),
                 torch.as_tensor(new_lbs), torch.as_tensor(new_nodes), cap)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _stable_reference(rest_lbs, new_lbs, cap):
    """The merge's contract: the stable argsort of concat([rest, new])
    with NaN ranked as +inf (its value kept)."""
    all_lbs = np.concatenate([rest_lbs, new_lbs], axis=1)
    key = np.where(np.isnan(all_lbs), np.inf, all_lbs)
    order = np.argsort(key, axis=1, kind="stable")
    return np.take_along_axis(all_lbs, order, axis=1)[:, :cap], order


@pytest.mark.parametrize("kind", ["random", "ties_and_inf", "nan"])
def test_merge_equals_jax(kind):
    rng = np.random.default_rng(0)
    if kind == "random":
        rest = np.sort(rng.uniform(0, 10, (3, 24)).astype(np.float32), axis=1)
        new = rng.uniform(0, 10, (3, 16)).astype(np.float32)
        cap = 24
    elif kind == "ties_and_inf":
        rest = np.array([[1.0, 2.0, 2.0, 2.0] + [np.inf] * 4] * 2,
                        np.float32)
        new = np.array([[2.0, 0.5, np.inf, 2.0, 3.0, np.inf, 2.0, 9.0],
                        [np.inf] * 8], np.float32)
        cap = 8
    else:
        rest = np.array([[1.0, 2.0, np.inf, np.inf],
                         [0.5, 3.0, np.nan, np.nan]], np.float32)
        new = np.array([[np.nan, 0.5, 3.0, np.nan],
                        [3.0, np.nan, 0.25, 3.0]], np.float32)
        cap = 6
    (k, n, d), (kw, nw, dw) = _both(rest, new, cap)
    # values and order, NaN where JAX has NaN
    np.testing.assert_array_equal(k, kw)
    np.testing.assert_array_equal(d, dw)
    # the payload rides with its lb: every slot of the kept frontier
    np.testing.assert_array_equal(n, nw)
    want, order = _stable_reference(rest, new, cap)
    np.testing.assert_array_equal(k, want)
    fin = np.isfinite(want)
    R = rest.shape[1]
    ids = np.where(order[:, :cap] < R, order[:, :cap], -1 - order[:, :cap])
    np.testing.assert_array_equal((n[..., 0] >= 0)[fin], (ids >= 0)[fin])


def test_device_engine_sorted_merge_identical():
    """tests/test_sorted_merge.py's pair (at MSEThresh 0.05, a shorter
    search): sorted_merge=1 gives the port the trajectory of
    sorted_merge=0, and the JAX package's with either."""
    jcfg0 = _cfg(MSEThresh=0.05, regularization=0.0005, ponderation=1,
                 distTransSize=16)
    jp, *_ = _pair(jcfg0, seed=3)
    tp = pair_from_jax(jp, "cpu")
    jcfg1 = dataclasses.replace(jcfg0, sorted_merge=1)
    want = jax.device_get(jeng.register_device(jp, jcfg1))
    r0 = teng.register_device(tp, _port_cfg(jcfg0))
    r1 = teng.register_device(tp, _port_cfg(jcfg1))
    assert float(r0.error) == float(r1.error)
    np.testing.assert_array_equal(r0.R.numpy(), r1.R.numpy())
    for f in ("evals", "outer_iters", "inner_iters", "icp_runs", "opt_comp",
              "geom_surv", "chem_corners"):
        assert int(getattr(r0, f)) == int(getattr(r1, f)), f
        assert int(getattr(r1, f)) == int(getattr(want, f)), f
    np.testing.assert_allclose(float(r1.error), float(want.error),
                               rtol=1e-5, atol=1e-5)
