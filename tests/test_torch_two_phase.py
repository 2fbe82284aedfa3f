"""Two-phase bound evaluation (cfg.chem_survivors) in the port: the four
cases of tests/test_two_phase.py, on its pair at MSEThresh 0.03 instead of
0.01 (72 outer steps instead of 359, the same optimum), each with the
port's result held equal to the JAX package's on the same pair (counters
exact, error within 1e-5):
  * a budget covering every child (8 * trans_pop) gives the lattice path's
    trajectory, fused and two-pass;
  * a small budget stays sound (an achievable incumbent, a valid gap) and
    evaluates fewer chem corners per inner iteration; at the JAX test's
    own MSEThresh 0.01, where the two packages' trajectories once split
    (at the initial ICP's means), the first 40 outer steps are equal too;
  * the counters exist without chem terms;
  * the fused stream with a budget gives register_device's results."""

import jax
import numpy as np
import pytest
import torch

from goicp_tpu.search.device_engine import register_device as jregister
from goicp_tpu.search.fused_stream import register_fused_stream as jstream
from goicp_tpu_torch.pipeline.prepare import pair_from_jax
from goicp_tpu_torch.search.device_engine import register_device
from goicp_tpu_torch.search.fused_stream import register_fused_stream
from tests.test_torch_device_engine import _port_cfg
from tests.test_two_phase import _cfg as _jcfg, _pair

torch.set_num_threads(1)


def _cfg(**kw):
    return _jcfg(**{"MSEThresh": 0.03, **kw})


_COUNTERS = ("outer_iters", "evals", "inner_iters", "icp_runs", "opt_comp",
             "geom_surv", "chem_corners", "converged")


def _both(jcfg, jp):
    """The JAX package's and the port's register_device on one pair."""
    want = jax.device_get(jregister(jp, jcfg))
    got = register_device(pair_from_jax(jp, "cpu"), _port_cfg(jcfg))
    for f in _COUNTERS:
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    for f in ("error", "R", "t", "gap"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    return got


@pytest.mark.parametrize("fused_inner", [1, 0])
def test_full_budget_identical_trajectory(fused_inner):
    jcfg0 = _cfg(fused_inner=fused_inner)
    jp = _pair(jcfg0)
    r0 = _both(jcfg0, jp)
    r2 = _both(_cfg(fused_inner=fused_inner,
                    chem_survivors=8 * jcfg0.trans_pop), jp)
    assert float(r0.error) == float(r2.error)
    for f in ("R", "t"):
        np.testing.assert_array_equal(getattr(r0, f).numpy(),
                                      getattr(r2, f).numpy())
    for f in ("opt_comp", "evals", "outer_iters", "inner_iters",
              "geom_surv"):
        assert int(getattr(r0, f)) == int(getattr(r2, f)), f
    assert int(r0.chem_corners) > 0 and int(r2.chem_corners) > 0


def test_small_budget_sound_and_cheaper_per_eval():
    jcfg0 = _cfg()
    jp = _pair(jcfg0)
    r0 = _both(jcfg0, jp)
    rS = _both(_cfg(chem_survivors=8), jp)
    eps = jcfg0.MSEThresh * jp.inlier_num
    assert float(rS.error) >= float(r0.error) - eps - 1e-5
    assert float(rS.gap) >= -1e-5
    assert (int(rS.chem_corners) / max(int(rS.inner_iters), 1)
            < int(r0.chem_corners) / max(int(r0.inner_iters), 1))


def test_small_budget_at_msethresh_001_matches_jax():
    """tests/test_two_phase.py's configuration itself (MSEThresh 0.01,
    chem_survivors=8), cut to 40 outer steps: every counter equal to the
    JAX package's, error, R, t and gap within 1e-5.  (Run to its 600
    steps, neither search converges, and the two stay equal: 14,647,392
    evals each, errors 3.55729008 and 3.55729032.)"""
    jcfg = _jcfg(chem_survivors=8, max_outer_steps=40)
    r = _both(jcfg, _pair(jcfg))
    assert int(r.outer_iters) == 40 and not bool(r.converged)


def test_counters_present_without_chem():
    jcfg = _cfg(regularization=0.0, ponderation=0)
    r = _both(jcfg, _pair(jcfg))
    assert int(r.chem_corners) == 0
    assert int(r.geom_surv) > 0


def test_fused_stream_two_phase_matches_device():
    jcfg = _cfg(chem_survivors=16, rot_batch=1, trans_pop=2,
                trans_capacity=32)
    jpairs = [_pair(jcfg, seed=s, pad=True) for s in (3, 5)]
    pairs = [pair_from_jax(p, "cpu") for p in jpairs]
    cfg = _port_cfg(jcfg)
    out = register_fused_stream(pairs, cfg, width=2, chunk_steps=64)
    want = jstream(jpairs, jcfg, width=2, chunk_steps=64)
    for f in ("outer_iters", "evals", "inner_iters", "icp_runs", "opt_comp",
              "chem_corners", "converged"):
        np.testing.assert_array_equal(np.asarray(getattr(out, f)),
                                      np.asarray(getattr(want, f)), f)
    for i, p in enumerate(pairs):
        single = register_device(p, cfg)
        assert abs(float(out.error[i]) - float(single.error)) <= 1e-5
        assert int(out.evals[i]) == int(single.evals)
        # the chem kernel's volume depends on the engine (lane compaction)
        assert int(out.chem_corners[i]) >= int(single.chem_corners)
