"""The port's batch engines (goicp_tpu_torch/search/chunked.py and
device_engine.py's register_device_batch / device_run_chunk) vs the JAX
package's register_device_batch_compact and the port's own
register_device, on the same prepared pairs: outer_iters, evals,
inner_iters, icp_runs, opt_comp, geom_surv and converged equal, error
within 1e-5.  (chem_corners, the chem kernel's volume, depends on the
engine: register_device compacts its lanes, the batch does not.)"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from goicp_tpu.search.chunked import \
    register_device_batch_compact as jcompact
from goicp_tpu_torch import config as tconfig
from goicp_tpu_torch.pipeline.prepare import pair_from_jax
from goicp_tpu_torch.search import chunked, device_engine
from tests._torch_ranks import one_rank_mesh
from tests.test_chunked import _batch, _cfg

# The port's CPU search is a loop of small torch ops; intra-op threads only
# contend with the parallel test workers.  One thread gives the same results.
torch.set_num_threads(1)

_COUNTERS = ("outer_iters", "evals", "inner_iters", "icp_runs", "opt_comp",
             "geom_surv", "converged")
# test_chunked.py's four mixed pairs at MSEThresh 0.01: 107, 1, 124 and 89
# outer steps, so 8-step chunks compact the batch 4 -> 2 -> 1
_SPECS = [(1, 40, 44, 0.0), (2, 48, 52, 0.0), (3, 36, 40, 0.03),
          (4, 44, 48, 0.0)]


def _port_cfg(cfg):
    return tconfig.GoICPConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(tconfig.GoICPConfig)})


def _assert_rows(got, want, rows=None):
    rows = range(len(np.asarray(want.error))) if rows is None else rows
    for f in _COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f))[list(rows)],
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(np.asarray(got.error)[list(rows)],
                               np.asarray(want.error), rtol=1e-5, atol=1e-5)


def _take_rows(res, rows):
    return device_engine.DeviceResult(*(np.asarray(v)[rows] for v in res))


def _stack(results):
    """[DeviceResult of one pair] -> one DeviceResult of numpy rows."""
    return device_engine.DeviceResult(*(
        np.stack([np.asarray(getattr(r, f).cpu()) if torch.is_tensor(
            getattr(r, f)) else np.asarray(getattr(r, f)) for r in results])
        for f in device_engine.DeviceResult._fields))


@pytest.fixture(scope="module")
def case():
    jcfg = _cfg(MSEThresh=0.01)
    jpairs = _batch(jcfg, _SPECS)
    cfg = _port_cfg(jcfg)
    pairs = [pair_from_jax(p, "cpu") for p in jpairs]
    single = _stack([device_engine.register_device(p, cfg) for p in pairs])
    chunked.reset_counters()
    out = chunked.register_device_batch_compact(pairs, cfg, chunk_steps=8)
    widths = list(chunked.counters["widths"])
    return dict(jcfg=jcfg, jpairs=jpairs, cfg=cfg, pairs=pairs,
                single=single, out=out, widths=widths)


def test_compact_matches_jax_batch_and_register_device(case):
    out = case["out"]
    assert out.error.shape == (4,) and out.R.shape == (4, 3, 3)
    assert bool(np.all(out.converged))
    # the batch compacted 4 -> 2 -> 1 as its pairs converged
    assert case["widths"][0] == 4 and 2 in case["widths"] \
        and case["widths"][-1] == 1
    want = jax.device_get(jcompact(case["jpairs"], case["jcfg"],
                                   chunk_steps=8))
    # pair 0's trajectory splits between the packages as register_device's
    # does (ROADMAP Queue 3; re-examined on the tree with the float32 FMA
    # and sincos32): its identity error is a sum over points taken in
    # another order (3.3831165 in JAX, 3.3831158 here), a near-tie pop
    # follows, and both converge to error 0 in 83 and 107 outer steps
    _assert_rows(out, _take_rows(want, [1, 2, 3]), rows=[1, 2, 3])
    assert bool(want.converged[0]) and abs(
        float(out.error[0]) - float(want.error[0])) <= 1e-5
    _assert_rows(out, case["single"])
    _assert_rows(device_engine.register_device_batch(case["pairs"],
                                                     case["cfg"]),
                 case["single"])


def test_compact_checkpoint_resume(case, tmp_path):
    """A run stopped after its first chunk resumes from the checkpoint to
    the uninterrupted run's results; the pad rows of pad_to never search
    (they retire at the first compaction with 0 outer steps, 0 evals)."""
    ckpt = str(tmp_path / "state.npz")
    pairs, cfg = case["pairs"][2:], case["cfg"]
    with pytest.raises(RuntimeError, match="in flight"):
        chunked.register_device_batch_compact(
            pairs, cfg, chunk_steps=8, checkpoint_path=ckpt, max_chunks=1,
            pad_to=4)
    state, active_idx, done = chunked.load_state(ckpt, "cpu")
    assert sorted(done) == [2, 3] and list(active_idx) == [0, 1]
    for i in (2, 3):
        assert int(done[i].outer_iters) == 0 and int(done[i].evals) == 0
    assert state["it"].tolist() == [8, 8]
    resumed = chunked.register_device_batch_compact(
        pairs, cfg, chunk_steps=8, checkpoint_path=ckpt, resume=True,
        pad_to=4)
    _assert_rows(resumed, _take_rows(case["out"], [2, 3]))


def test_save_load_state_round_trip(case, tmp_path):
    """A batch state, its rows and its retired results survive the file:
    values, dtypes and shapes."""
    pb = chunked.stack_pairs(case["pairs"][:2])
    state = device_engine.batch_run_chunk(
        pb, case["cfg"], device_engine.batch_init(pb, case["cfg"]), 3)
    done = {5: device_engine.DeviceResult(
        *(np.asarray(v)[0] for v in case["out"]))}
    path = str(tmp_path / "s.npz")
    chunked.save_state(path, state, np.array([0, 1]), done)
    got, active_idx, got_done = chunked.load_state(path, "cpu")
    assert list(active_idx) == [0, 1] and sorted(got_done) == [5]
    assert set(got) == set(state)
    for k, v in state.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    for f, a, b in zip(device_engine.DeviceResult._fields, got_done[5],
                       done[5]):
        np.testing.assert_array_equal(a, b, f)


def test_device_run_chunk_in_chunks_of_three(case):
    """init -> run_chunk x n -> finalize is register_device, exactly."""
    cfg = case["cfg"]
    for i in (1, 3):
        pair = case["pairs"][i]
        s = device_engine.device_init(pair, cfg)
        n = 0
        while not bool(s["converged"]) and int(s["it"]) < cfg.max_outer_steps:
            s = device_engine.device_run_chunk(pair, cfg, s, 3)
            n += 1
        got = device_engine.device_finalize(s)
        assert n == -(-int(case["single"].outer_iters[i]) // 3)
        want = device_engine.DeviceResult(
            *(np.asarray(v)[i] for v in case["single"]))
        for f in _COUNTERS + ("chem_corners", "last_icp"):
            assert int(getattr(got, f)) == int(getattr(want, f)), f
        for f in ("error", "R", "t", "gap", "terms"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          getattr(want, f), f)


def test_device_stream_matches_compact(case):
    """register_device_stream (the fused stream underneath, width 2)
    gives the compacting runner's per-pair results."""
    out = chunked.register_device_stream(case["pairs"], case["cfg"],
                                         width=2, chunk_steps=8)
    _assert_rows(out, case["out"])


def test_mesh_waits_for_the_multi_gpu_engines(case):
    """mesh= is ported: both batch engines over the data axis of a one-rank
    mesh give the unsharded rows (tests/test_torch_straggler.py runs them
    over four ranks)."""
    with one_rank_mesh() as mesh:
        for fn in (chunked.register_device_batch_compact,
                   device_engine.register_device_batch):
            _assert_rows(fn(case["pairs"], case["cfg"], mesh=mesh),
                         case["out"])
