"""The port's slot-packed cross-pair stream (goicp_tpu_torch/search/
packed_stream.py): the five cases of tests/test_packed_stream.py on the
port (per pair equal to the port's register_device; the slot budget is pure
scheduling; trimmed pairs; checkpoint/resume; unsupported chem terms
rejected), plus the JAX package's register_packed_stream on the same pairs
(its Pallas kernels in interpret mode).  Counters exact, error within 1e-5.
On the CPU the port's bounds go through the plain versions of K3 and K4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from goicp_tpu.search import packed_stream as jps
from goicp_tpu_torch.search import packed_stream as tps
from goicp_tpu_torch.search.device_engine import register_device
from tests.test_fused_stream import _pairs, _small_cfg  # seeds differ: the
# port's CPU path recomputes the minimum over cells, so the cases here use
# pairs with shorter searches than the JAX package's own stream tests
from tests.test_torch_fused_stream import _port_cfg, _port_pairs

torch.set_num_threads(1)    # see tests/test_torch_fused_stream.py


def _packed_cfg(**over):
    over.setdefault("packed_slots", 5)
    return dataclasses.replace(_small_cfg(), **over)


def _equal(a, b, fields=("error", "outer_iters", "evals", "opt_comp")):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), f)


@pytest.fixture(scope="module")
def case():
    jcfg = _packed_cfg()
    jpairs = _pairs(jcfg, n=3)
    cfg = _port_cfg(jcfg)
    pairs = _port_pairs(jpairs)
    assert tps.supports_packed(pairs[0], cfg)
    out = tps.register_packed_stream(pairs, cfg, width=2, chunk_steps=64)
    return dict(jcfg=jcfg, jpairs=jpairs, cfg=cfg, pairs=pairs, out=out)


def test_packed_stream_matches_register_device(case):
    out, cfg = case["out"], case["cfg"]
    for i, pair in enumerate(case["pairs"]):
        ref = register_device(pair, cfg)
        assert bool(out.converged[i]) == bool(ref.converged), i
        np.testing.assert_allclose(out.error[i], float(ref.error),
                                   rtol=1e-5, atol=1e-5)
        for f in ("outer_iters", "evals", "opt_comp", "icp_runs"):
            assert int(getattr(out, f)[i]) == int(getattr(ref, f)), (i, f)
        # inner_iters counts lane-iterations here, sequential depth there
        assert int(out.inner_iters[i]) >= int(ref.inner_iters), i
        assert float(out.gap[i]) <= cfg.MSEThresh * float(
            pair.counts[1]) + 1e-3


def test_packed_stream_matches_jax_stream(case):
    want = jps.register_packed_stream(case["jpairs"], case["jcfg"], width=2,
                                      chunk_steps=64)
    out = case["out"]
    _equal(out, want, ("converged", "outer_iters", "evals", "opt_comp",
                       "inner_iters", "icp_runs"))
    np.testing.assert_allclose(out.error, np.asarray(want.error),
                               rtol=1e-5, atol=1e-5)


def test_packed_slot_count_invariance():
    """The slot budget is pure scheduling: S=2 and S=16 must produce the
    identical per-pair results (trajectory equality, not just epsilon)."""
    jcfg2 = _packed_cfg(packed_slots=2)
    pairs = _port_pairs(_pairs(jcfg2, n=3, seed=2))
    a = tps.register_packed_stream(pairs, _port_cfg(jcfg2), width=3,
                                   chunk_steps=48)
    b = tps.register_packed_stream(pairs, _port_cfg(jcfg2, packed_slots=16),
                                   width=3, chunk_steps=48)
    _equal(a, b)
    np.testing.assert_array_equal(a.R, b.R)


def test_packed_trimmed_matches_device():
    jcfg = _packed_cfg(trimFraction=0.15)
    cfg = _port_cfg(jcfg)
    pairs = _port_pairs(_pairs(jcfg, n=2, seed=9))
    out = tps.register_packed_stream(pairs, cfg, width=2, chunk_steps=64)
    for i, pair in enumerate(pairs):
        ref = register_device(pair, cfg)
        assert bool(out.converged[i]) and bool(ref.converged), i
        np.testing.assert_allclose(out.error[i], float(ref.error),
                                   rtol=1e-5, atol=1e-5)
        assert int(out.outer_iters[i]) == int(ref.outer_iters), i
        assert int(out.opt_comp[i]) == int(ref.opt_comp), i


def test_packed_checkpoint_resume(case, tmp_path):
    """Kill mid-run (max_chunks), resume from the checkpoint: identical
    results to the uninterrupted run."""
    cfg, pairs = case["cfg"], case["pairs"]
    ref = tps.register_packed_stream(pairs, cfg, width=2, chunk_steps=24)
    _equal(ref, case["out"])        # the chunk length is pure pacing too
    ck = str(tmp_path / "packed_ck.npz")
    with pytest.raises(RuntimeError, match="max_chunks"):
        tps.register_packed_stream(pairs, cfg, width=2, chunk_steps=24,
                                   checkpoint_path=ck, max_chunks=2)
    with np.load(ck) as z:
        assert z["state_ss"].dtype == np.float32
        assert z["state_converged"].dtype == np.bool_
        assert z["state_it"].dtype == np.int32
    out = tps.register_packed_stream(pairs, cfg, width=2, chunk_steps=24,
                                     checkpoint_path=ck, resume=True)
    _equal(ref, out)


def test_packed_rejects_unsupported_config():
    jcfg = _packed_cfg(regularizationNeighbors=0.1)
    pairs = _port_pairs(_pairs(jcfg, n=2, seed=3))
    with pytest.raises(ValueError):
        tps.register_packed_stream(pairs, _port_cfg(jcfg), width=2)
