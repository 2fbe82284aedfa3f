"""The port's multi-GPU streams and batches (goicp_tpu_torch/search/
fused_stream.py with a mesh and straggler_to_lane_sharded, the batch
engines with a mesh): four gloo ranks on the CPU (dist/spawn.run_ranks;
their side is tests/_torch_ranks.py::straggler_ranks), held to the JAX
package (on conftest's 8 virtual devices) and to the port's unsharded
engines, on tests/test_fused_stream.py's three pairs.

  * the straggler handoff: a mid-flight row of the JAX fused stream (pair
    2 after 40 global iterations, brought over with stream_state_from_jax)
    searched on with its lanes over 4 ranks: converged, within eps of
    register_device with gap <= eps, and equal in every counter to JAX's
    handoff of the same row on a 1 x 4 mesh;
  * the fused stream over a 2 x 2 mesh (window 2 split over `data`, the
    last live pair handed off over `search`): every pair converged within
    eps of register_device; the two pairs that finish in the window equal
    it in the counters the unsharded stream's tests hold equal;
  * register_device_batch and register_device_batch_compact over the same
    mesh (three pairs in two data blocks, the second padded): row-equal to
    the unsharded register_device_batch; the compacting batch and the
    stream stopped after one chunk (max_chunks=1, each rank's own
    checkpoint) and resumed: equal to their uninterrupted runs;
  * the pipelines over the same mesh on tests/test_torch_pair.py's pairs:
    run_sweep_device_batch with both runners, only rank 0 writing files,
    every rank's rows equal to the unsharded sweep's (the fused runner's
    within eps: its last live pair is handed off), and register_batch.
"""

import concurrent.futures
import os

import jax
import numpy as np
import pytest
import torch

from goicp_tpu.config import GoICPConfig as JaxConfig
from goicp_tpu.dist.mesh import make_mesh as jax_mesh
from goicp_tpu.dist.mesh import stack_pairs as jax_stack
from goicp_tpu.search import fused_stream as jax_fs
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.dist.spawn import run_ranks
from goicp_tpu_torch.search import fused_stream as fs
from goicp_tpu_torch.search.device_engine import (register_device,
                                                  register_device_batch)
from tests._torch_ranks import STREAM_CFG, stream_pairs
from tests.test_fused_stream import _pairs

# The port's CPU search is a loop of small torch ops; intra-op threads only
# contend with the parallel test workers.  One thread gives the same results.
torch.set_num_threads(1)

_COUNTERS = ("outer_iters", "evals", "inner_iters", "icp_runs", "opt_comp",
             "geom_surv", "chem_corners", "converged", "last_icp")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX mid-flight row, the ranks' results (a Future: JAX and the
    port's references compute beside them) and the port's pairs."""
    jcfg = JaxConfig(**STREAM_CFG)
    jpairs = _pairs(jcfg, n=3)
    pb = jax_stack([jpairs[2]])
    state = jax_fs.fused_run_chunk(pb, jcfg, jax_fs._jit_init(jcfg)(pb),
                                   np.int32(40))
    assert not bool(np.asarray(state["converged"])[0])     # mid-flight
    row = jax.tree_util.tree_map(lambda x: x[0], state)
    tmp = tmp_path_factory.mktemp("straggler")
    path = str(tmp / "row.npz")
    np.savez(path, **fs._flatten_state(fs.stream_state_from_jax(row, "cpu")))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_ranks, "tests._torch_ranks:straggler_ranks", 4,
                      kwargs=dict(row_path=path, out_dir=str(tmp / "sweep")),
                      device="cpu", timeout_s=300)
    cfg = GoICPConfig(**STREAM_CFG)
    yield dict(jcfg=jcfg, jpairs=jpairs, jrow=row, ranks=fut, cfg=cfg,
               pairs=stream_pairs(cfg, "cpu"), tmp=tmp)
    pool.shutdown()


def _rows(case, key, skip=()):
    """The run `key` as every rank returned it (all equal but the fields
    in skip)."""
    outs = case["ranks"].result()
    fields = [f for f in outs[0] if f.startswith(key + ".")]
    for out in outs[1:]:
        for f in fields:
            if f[len(key) + 1:] not in skip:
                np.testing.assert_array_equal(out[f], outs[0][f], f)
    return {f[len(key) + 1:]: outs[0][f] for f in fields}


def _eps(cfg, pair) -> float:
    return cfg.MSEThresh * float(pair.counts[1]) + 1e-5


def test_straggler_handoff_mid_flight_converges(case):
    cfg, pair = case["cfg"], case["pairs"][2]
    want = jax.device_get(jax_fs.straggler_to_lane_sharded(
        case["jpairs"][2], case["jcfg"], case["jrow"],
        jax_mesh(n_data=1, n_search=4)))
    ref = register_device(pair, cfg)
    got = _rows(case, "handoff")
    assert bool(got["converged"])
    # the handoff searches the in-flight pop again from its harvested lbs:
    # the trajectory differs from register_device's, the guarantee not
    assert abs(float(got["error"]) - float(ref.error)) <= _eps(cfg, pair)
    assert float(got["gap"]) <= _eps(cfg, pair)
    for f in _COUNTERS:
        assert int(got[f]) == int(getattr(want, f)), f
    np.testing.assert_allclose(got["error"], np.asarray(want.error),
                               rtol=1e-5, atol=1e-5)


def test_fused_stream_with_data_and_search_mesh(case):
    cfg = case["cfg"]
    got = _rows(case, "stream")
    for i, pair in enumerate(case["pairs"]):
        ref = register_device(pair, cfg)
        assert bool(got["converged"][i]), i
        assert abs(float(got["error"][i]) - float(ref.error)) \
            <= _eps(cfg, pair), i
        assert float(got["gap"][i]) <= _eps(cfg, pair), i
        if i < 2:       # pair 2 is the window's straggler, handed off
            # the counters tests/test_torch_fused_stream.py holds equal
            # (the stream evaluates its chem corners without lane compaction)
            for f in ("outer_iters", "evals", "opt_comp", "inner_iters",
                      "icp_runs", "converged"):
                assert int(got[f][i]) == int(getattr(ref, f)), (i, f)
    assert int(got["evals"][2]) != int(register_device(
        case["pairs"][2], cfg).evals)


@pytest.mark.parametrize("engine", ["batch", "compact"])
def test_batches_with_mesh_row_equal(case, engine):
    want = register_device_batch(case["pairs"], case["cfg"])
    got = _rows(case, engine)
    for f in want._fields:
        np.testing.assert_array_equal(got[f], getattr(want, f), f)


@pytest.mark.parametrize("engine", ["compact", "stream"])
def test_meshed_checkpoint_resumes(case, engine):
    """Stopped after one chunk (pair 2 needs 14 outer steps) with a
    checkpoint per rank, then resumed: the uninterrupted run's rows."""
    outs = case["ranks"].result()
    assert all(bool(out[f"{engine}_stopped"]) for out in outs)
    got, want = _rows(case, f"{engine}_resumed"), _rows(case, engine)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], f)


@pytest.mark.parametrize("runner", ["compact", "fused"])
def test_sweep_with_mesh_rank0_writes(case, runner, tmp_path):
    from goicp_tpu_torch.pipeline.device_sweep import run_sweep_device_batch
    from tests._torch_ranks import PIPE_CFG, write_pipe_root
    root = str(tmp_path / "root")
    write_pipe_root(root)
    cfg = GoICPConfig(**PIPE_CFG)
    want = run_sweep_device_batch(root, cfg, str(tmp_path / "out"),
                                  runner=runner, device="cpu")
    got = _rows(case, f"sweep_{runner}", skip=("rmsd",))
    out_dir = case["tmp"] / "sweep" / runner
    with open(out_dir / "results_similar.jsonl") as fh:
        assert len(fh.readlines()) == len(want) == 2   # rank 0's rows only
    assert sorted(os.listdir(out_dir / "output")) == sorted(
        os.listdir(tmp_path / "out" / "output"))
    for out in case["ranks"].result()[1:]:
        assert np.isnan(out[f"sweep_{runner}.rmsd"]).all()   # no files
    for i, w in enumerate(want):
        assert bool(got["converged"][i]) and got["rmsd"][i] < 1e-4, i
        if runner == "fused":
            nd = (40, 48)[i]          # write_pipe_root's data points
            assert abs(got["error"][i] - w["error"]) \
                <= cfg.MSEThresh * nd + 1e-5, i
            continue
        assert abs(got["error"][i] - w["error"]) <= 1e-5, i
        for k in ("outer_steps", "bound_evals", "icp_runs"):
            assert got[k][i] == w[k], (i, k)


def test_register_batch_with_mesh(case):
    from tests._torch_ranks import PIPE_CFG, static_pairs
    cfg = GoICPConfig(**PIPE_CFG)
    got = _rows(case, "register_batch")
    for i, pair in enumerate(static_pairs(cfg, "cpu")):
        w = register_device(pair, cfg)
        assert abs(float(got["error"][i]) - float(w.error)) \
            <= cfg.MSEThresh * pair.inlier_num + 1e-5, i
