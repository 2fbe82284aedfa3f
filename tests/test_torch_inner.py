"""Port inner translation BnB (goicp_tpu_torch/search/inner.py) vs the JAX
inner_bnb on the same pair (pair_from_jax): per-lane results with fused
bounds, chem corner reuse and staged lane compaction.  Counters and the
winning nodes must be equal; best_err / lb_safe within 1e-5 relative."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goicp_tpu.config import GoICPConfig
from goicp_tpu.geom.rotation import rodrigues_np
from goicp_tpu.pipeline import prepare as jprep
from goicp_tpu.search import inner as jinner
from goicp_tpu_torch.pipeline.prepare import pair_from_jax
from goicp_tpu_torch.search import inner as tinner

# small torch ops in a loop: intra-op threads only contend with the
# parallel test workers (see test_torch_device_engine.py)
torch.set_num_threads(1)


def _case(seed=0, n=40, trim=0.0, dynamic=False, **cfg_kw):
    cfg = GoICPConfig(**{"MSEThresh": 0.01, "regularization": 0.0005,
                         "ponderation": 1, "distTransSize": 12,
                         "trans_capacity": 64, "trans_pop": 4,
                         "inner_max_iters": 200, "chem_reuse": 1,
                         "lane_compaction": 1, "trimFraction": trim,
                         **cfg_kw})
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-0.8, 0.8, size=(n + 8, 3))
    R = rodrigues_np(rng.uniform(-1.0, 1.0, 3))
    src = (tgt[:n] - 0.05) @ R.T
    props = rng.integers(0, 9, size=n + 8).astype(np.int32)
    jp = jprep.prepare_pair(src, tgt, props[:n], props, cfg, pad_data_to=64)
    if dynamic:
        jp = jprep.make_count_dynamic(jp)
    L = 8
    rots = np.stack([rodrigues_np(v) for v in rng.uniform(-2, 2, (L, 3))])
    pts = np.einsum("lij,nj->lni", rots, np.asarray(jp.data)
                    ).astype(np.float32)
    widths = rng.uniform(0.2, 1.2, size=(L,)).astype(np.float32)
    active = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    return cfg, jp, pts, widths, active


@pytest.mark.parametrize("variant", [
    dict(fused=True),
    dict(fused=True, cfg=dict(chem_reuse=0)),
    dict(fused=True, cfg=dict(lane_compaction=0)),
    dict(fused=True, trim=0.1, dynamic=True),
    dict(fused=True, trim=0.1),
    dict(fused=False, unc=True),
    dict(fused=False, unc=False, cfg=dict(regularization=0.0)),
])
def test_inner_bnb_matches_jax(variant):
    cfg, jp, pts, widths, active = _case(
        seed=1, trim=variant.get("trim", 0.0),
        dynamic=variant.get("dynamic", False), **variant.get("cfg", {}))
    tp = pair_from_jax(jp, "cpu")
    fused = variant["fused"]
    unc = variant.get("unc", False)
    inc = 40.0
    want = jinner.inner_bnb(jp, cfg, jnp.asarray(pts), jnp.asarray(widths),
                            jnp.asarray(active), jnp.float32(inc),
                            with_rot_uncertainty=unc, fused=fused)
    got = tinner.inner_bnb(tp, cfg, torch.as_tensor(pts),
                           torch.as_tensor(widths), torch.as_tensor(active),
                           torch.tensor(inc), with_rot_uncertainty=unc,
                           fused=fused)
    assert got.iters == int(want.iters)
    assert int(got.evals) == int(want.evals)
    assert int(got.geom_surv) == int(want.geom_surv)
    assert got.chem_corners == int(want.chem_corners)
    assert got.iters > 2 and int(got.evals) > 0
    np.testing.assert_array_equal(got.best_node.numpy(),
                                  np.asarray(want.best_node))
    for f in ("best_err", "lb_safe", "ub_terms"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def test_root_corner_values_match_jax():
    cfg, jp, pts, _, _ = _case(seed=2)
    tp = pair_from_jax(jp, "cpu")
    want = jinner.root_corner_values(jp, cfg, jnp.asarray(pts))
    got = tinner.root_corner_values(tp, cfg, torch.as_tensor(pts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tinner._LAT_FROM_STORED,
                                  jinner._LAT_FROM_STORED)


def test_unported_options_raise():
    """sorted_merge and chem_survivors (full and small budgets) run in the
    port's inner_bnb, each equal to the JAX inner_bnb with the same knob."""
    cfg, jp, pts, widths, active = _case(seed=3)
    tp = pair_from_jax(jp, "cpu")
    for kw in (dict(sorted_merge=1), dict(chem_survivors=8),
               dict(chem_survivors=8 * cfg.trans_pop)):
        c = dataclasses.replace(cfg, **kw)
        want = jinner.inner_bnb(jp, c, jnp.asarray(pts), jnp.asarray(widths),
                                jnp.asarray(active), jnp.float32(40.0),
                                with_rot_uncertainty=False, fused=True)
        got = tinner.inner_bnb(tp, c, torch.as_tensor(pts),
                               torch.as_tensor(widths),
                               torch.as_tensor(active), torch.tensor(40.0),
                               with_rot_uncertainty=False, fused=True)
        assert got.iters == int(want.iters), kw
        assert int(got.evals) == int(want.evals), kw
        assert int(got.geom_surv) == int(want.geom_surv), kw
        assert got.chem_corners == int(want.chem_corners), kw
        np.testing.assert_array_equal(got.best_node.numpy(),
                                      np.asarray(want.best_node))
        for f in ("best_err", "lb_safe", "ub_terms"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
