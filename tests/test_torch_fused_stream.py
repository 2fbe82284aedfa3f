"""The port's cross-pair fused stream (goicp_tpu_torch/search/
fused_stream.py) vs the port's own register_device and vs the JAX package's
register_fused_stream, pair by pair on the same prepared pairs: converged
flags, outer_iters, evals and opt_comp equal, error within 1e-5 (fp32 sums
taken in another order).  On the CPU the stream's bounds go through the
plain versions of the per-lane-table kernels K3 and K4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from goicp_tpu.dist.mesh import stack_pairs as jstack_pairs
from goicp_tpu.search import fused_stream as jfs
from goicp_tpu_torch import config as tconfig
from goicp_tpu_torch.dist.mesh import stack_pairs
from goicp_tpu_torch.pipeline.prepare import pair_from_jax
from goicp_tpu_torch.search import fused_stream as tfs
from goicp_tpu_torch.search.device_engine import register_device
from tests.test_fused_stream import _pairs, _small_cfg

# The port's CPU search is a loop of small torch ops; intra-op threads only
# contend with the parallel test workers.  One thread gives the same results.
torch.set_num_threads(1)


def _port_cfg(cfg, **over):
    """The port's GoICPConfig with the JAX config's values."""
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(tconfig.GoICPConfig)}
    kw.update(over)
    return tconfig.GoICPConfig(**kw)


def _port_pairs(jpairs):
    return [pair_from_jax(p, "cpu") for p in jpairs]


def _assert_rows_equal(got, want, exact_error=False):
    for f in ("converged", "outer_iters", "evals", "opt_comp"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    if exact_error:
        np.testing.assert_array_equal(np.asarray(got.error),
                                      np.asarray(want.error))
    else:
        np.testing.assert_allclose(np.asarray(got.error),
                                   np.asarray(want.error),
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def case():
    """Three pairs, window of two: the pairs in both packages and the
    port's stream result, shared by the cases below."""
    jcfg = _small_cfg()
    jpairs = _pairs(jcfg, n=3)
    cfg = _port_cfg(jcfg)
    pairs = _port_pairs(jpairs)
    out = tfs.register_fused_stream(pairs, cfg, width=2, chunk_steps=64)
    return dict(jcfg=jcfg, jpairs=jpairs, cfg=cfg, pairs=pairs, out=out)


def test_fused_stream_matches_register_device(case):
    out = case["out"]
    assert out.error.shape == (3,) and out.R.shape == (3, 3, 3)
    for i, pair in enumerate(case["pairs"]):
        ref = register_device(pair, case["cfg"])
        assert bool(out.converged[i]) and bool(ref.converged), i
        np.testing.assert_allclose(out.error[i], float(ref.error),
                                   rtol=1e-5, atol=1e-5)
        for f in ("outer_iters", "evals", "opt_comp", "inner_iters",
                  "icp_runs"):
            assert int(getattr(out, f)[i]) == int(getattr(ref, f)), (i, f)


def test_fused_stream_matches_jax_stream(case):
    want = jfs.register_fused_stream(case["jpairs"], case["jcfg"], width=2,
                                     chunk_steps=64)
    _assert_rows_equal(case["out"], want)
    np.testing.assert_allclose(case["out"].t, np.asarray(want.t),
                               rtol=1e-5, atol=1e-5)


def test_one_chunk_from_the_same_jax_state(case):
    """Both packages start from the SAME mid-run window state
    (stream_state_from_jax) and advance it by the same 8 global
    iterations."""
    jcfg, cfg = case["jcfg"], case["cfg"]
    jpb = jstack_pairs(case["jpairs"][:2])
    jstate = jfs.fused_run_chunk(jpb, jcfg, jfs._jit_init(jcfg)(jpb),
                                 np.int32(12))
    start = tfs.stream_state_from_jax(jax.device_get(jstate), "cpu")
    assert start["it"].dtype == torch.int32
    assert start["inner"]["done"].dtype == torch.bool
    got = tfs.fused_run_chunk(stack_pairs(case["pairs"][:2]), cfg, start, 8)
    want = jax.device_get(jfs.fused_run_chunk(jpb, jcfg, jstate,
                                              np.int32(8)))
    assert int(got["inner"]["it"].sum()) > int(start["inner"]["it"].sum()) \
        or int(got["it"].sum()) > int(start["it"].sum())
    for k in ("it", "evals", "inner_it", "icp_runs", "converged", "active"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    for k in ("it", "evals", "done"):
        np.testing.assert_array_equal(got["inner"][k].numpy(),
                                      np.asarray(want["inner"][k]), k)
    for k in ("opt_err", "fr_lbs", "pts_rot"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("lbs", "opt_err", "thr", "nodes"):
        np.testing.assert_allclose(got["inner"][k].numpy(),
                                   np.asarray(want["inner"][k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_fused_stream_checkpoint_resume(tmp_path):
    """Kill the stream mid-run (max_chunks), resume from the checkpoint,
    and land on identical results (deterministic search)."""
    jcfg = _small_cfg()
    cfg = _port_cfg(jcfg)
    pairs = _port_pairs(_pairs(jcfg, n=4, seed=5))
    full = tfs.register_fused_stream(pairs, cfg, width=2, chunk_steps=16)

    ckpt = str(tmp_path / "stream.npz")
    with pytest.raises(RuntimeError, match="max_chunks"):
        tfs.register_fused_stream(pairs, cfg, width=2, chunk_steps=16,
                                  checkpoint_path=ckpt, max_chunks=2)
    with np.load(ckpt) as z:
        assert z["state_converged"].dtype == np.bool_
        assert z["state_inner.done"].dtype == np.bool_
        assert z["state_it"].dtype == np.int32
        assert z["state_inner.lbs"].dtype == np.float32
    resumed = tfs.register_fused_stream(pairs, cfg, width=2, chunk_steps=16,
                                        checkpoint_path=ckpt, resume=True)
    _assert_rows_equal(resumed, full, exact_error=True)
    np.testing.assert_array_equal(resumed.R, full.R)


def test_fused_stream_progress_and_refill():
    """Window narrower than the pair count: retire/refill must cover all
    pairs in order, and the progress callback surfaces in-flight
    telemetry."""
    jcfg = _small_cfg()
    pairs = _port_pairs(_pairs(jcfg, n=5, seed=3))
    seen = []
    out = tfs.register_fused_stream(pairs, _port_cfg(jcfg), width=2,
                                    chunk_steps=32, progress=seen.append)
    assert np.asarray(out.converged).all() and out.error.shape == (5,)
    assert len(seen) >= 1
    row = seen[0]["rows"][0]
    assert {"pair", "converged", "outer", "incumbent",
            "frontier_min"} <= set(row)
    assert [r["pair"] for r in seen[0]["rows"]] == [0, 1]
    order = []
    for ev in seen:
        for r in ev["rows"]:
            if not r["dead"] and r["pair"] not in order:
                order.append(r["pair"])
    assert order == [0, 1, 2, 3, 4]      # refills take pairs in order


@pytest.mark.parametrize("kw,cfg_over", [
    (dict(eager=True), {}),
    ({}, dict(trans_slots=1)),
], ids=["eager", "trans_slots_1"])
def test_fused_stream_pacing_knobs_change_nothing(case, kw, cfg_over):
    """eager refill and a transition budget of one row per event are pure
    pacing: identical per-pair results."""
    cfg = dataclasses.replace(case["cfg"], **cfg_over)
    out = tfs.register_fused_stream(case["pairs"], cfg, width=2,
                                    chunk_steps=64, **kw)
    _assert_rows_equal(out, case["out"], exact_error=True)
    np.testing.assert_array_equal(out.inner_iters, case["out"].inner_iters)


def test_fused_stream_neighbour_term_runs_row_by_row():
    """A chem term K3/K4 do not carry (neighbours): the inner step runs
    row by row on the per-pair path and still matches register_device."""
    jcfg = _small_cfg(regularizationNeighbors=0.001, max_outer_steps=6)
    pairs = _port_pairs(_pairs(jcfg, n=2, seed=7))
    cfg = _port_cfg(jcfg)
    out = tfs.register_fused_stream(pairs, cfg, width=2, chunk_steps=64)
    for i, pair in enumerate(pairs):
        ref = register_device(pair, cfg)
        np.testing.assert_allclose(out.error[i], float(ref.error),
                                   rtol=1e-5, atol=1e-5)
        assert int(out.outer_iters[i]) == int(ref.outer_iters), i
        assert int(out.evals[i]) == int(ref.evals), i


@pytest.mark.parametrize("kw,err,match", [
    (dict(mesh=object(), escalate_capacity=32), ValueError, "with mesh"),
    (dict(escalate_capacity=16), ValueError, "must exceed"),
], ids=["kw0-item 16", "kw1-item 18"])
def test_unported_options_raise(case, kw, err, match):
    """The options that still raise: escalation together with a mesh (as
    in the JAX package; mesh= and the straggler handoff themselves are
    ported, tests/test_torch_straggler.py); an escalation that does not
    widen the frontier (the JAX package ignores it), and a migration that
    narrows it."""
    with pytest.raises(err, match=match):
        tfs.register_fused_stream(case["pairs"], case["cfg"], width=2, **kw)
    with pytest.raises(ValueError, match="widen"):
        tfs.migrate_row_capacity({}, case["cfg"], dataclasses.replace(
            case["cfg"], trans_capacity=8))


def test_load_stream_state_defaults_to_the_default_device(tmp_path):
    """A checkpoint loads onto the card (cuda:0) unless the caller names a
    device; without a card, device=None is an error asking for "cpu"."""
    path = str(tmp_path / "state.npz")
    state = {"best": torch.arange(3, dtype=torch.float32),
             "inner": {"count": torch.tensor([2, 5], dtype=torch.int32)}}
    tfs.save_stream_state(path, state, [0, 1], [False, True], 2, {})
    if torch.cuda.is_available():
        assert tfs.load_stream_state(path)[0]["best"].device == \
            torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tfs.load_stream_state(path)
    got, rows_orig, dead, next_pair, done = tfs.load_stream_state(path,
                                                                  "cpu")
    assert got["inner"]["count"].dtype == torch.int32
    assert torch.equal(got["best"].cpu(), state["best"])
    assert (rows_orig, dead, next_pair, done) == ([0, 1], [False, True], 2,
                                                  {})
    assert tfs.load_stream_state(path, "cpu")[0]["best"].device.type == "cpu"
