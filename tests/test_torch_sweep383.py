"""The port's BO1-scale sweep tool (goicp_tpu_torch/tools/sweep383.py) on
the CPU, and the faults of the JAX tool (tools/sweep383.py) it must not
copy:

  (a) its rows equal the JAX tool's core (the JAX register_fused_stream per
      shape bucket, then bench.measure._reassemble) on the same buckets;
  (b) a stop asked for by --kill-after-chunks exits 3 with the stream's
      checkpoint under its exact name, and a fresh run resumes to the rows
      of an uninterrupted run, leaving no checkpoint or done file;
  (c) a resume under another --n or --buckets raises ValueError naming the
      field and leaves the files as they are;
  (d) every other error propagates and does not exit 3;
  (e) the savers write the exact path they are given, whatever its suffix,
      and a failed write leaves the previous checkpoint whole;
  (f) no default path is a file of the JAX tool, and .gitignore lists them.

Small seeded pairs (40-48 points, MSEThresh 0.01) in two buckets; the
command line runs on the bench pool's two cheapest pairs, syn00 and syn01.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from goicp_tpu.bench import measure as jmeasure
from goicp_tpu.geom.rotation import rodrigues_np
from goicp_tpu.pipeline import prepare as jprep
from goicp_tpu.search import fused_stream as jfs
from goicp_tpu_torch.pipeline.prepare import pair_from_jax
from goicp_tpu_torch.search import chunked
from goicp_tpu_torch.search import fused_stream as tfs
from goicp_tpu_torch.tools import sweep383
from tests.test_fused_stream import _small_cfg
from tests.test_torch_fused_stream import _port_cfg

# The port's CPU search is a loop of small torch ops; intra-op threads only
# contend with the parallel test workers.  One thread gives the same results.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ["pair", "error", "geom", "incomp", "fpfh", "compat", "gap",
          "converged", "outer", "inner", "evals", "icp_runs"]
COUNTERS = ("converged", "outer_iters", "inner_iters", "evals", "icp_runs",
            "opt_comp")
CHUNK = 16           # global iterations per chunk of the small sweeps


def _raw_pairs(n=4, seed=7):
    """n seeded raw pairs: a rigidly moved subset (40-48 points) of a
    44-48-point model, properties carried along."""
    rng = np.random.default_rng(seed)
    raw = []
    for _ in range(n):
        nm = int(rng.integers(44, 49))
        nd = int(rng.integers(40, nm + 1))
        model = rng.uniform(-0.7, 0.7, size=(nm, 3))
        R = rodrigues_np(rng.uniform(-2, 2, 3))
        sel = rng.permutation(nm)[:nd]
        data = (model[sel] - rng.uniform(-0.1, 0.1, 3)) @ R
        mp = rng.integers(0, 9, nm).astype(np.int32)
        raw.append((data, model, mp[sel].copy(), mp))
    return raw


@pytest.fixture(scope="module")
def small():
    """Four pairs in two shape buckets (pairs 0, 2 and 1, 3), prepared by
    the JAX package, and the port's copies of them."""
    jcfg = _small_cfg()
    raw = _raw_pairs()
    jbuckets = []
    for idxs in ([0, 2], [1, 3]):
        dims = [jprep.bucket_dims(raw[i][1], len(raw[i][0]), len(raw[i][1]),
                                  jcfg) for i in idxs]
        bd = {k: max(d[k] for d in dims) for k in dims[0]}
        jbuckets.append(([jprep.make_count_dynamic(
            jprep.prepare_pair(*raw[i], jcfg, **bd)) for i in idxs], idxs))
    tbuckets = [([pair_from_jax(p, "cpu") for p in ps], idxs)
                for ps, idxs in jbuckets]
    names = [f"small{i}" for i in range(len(raw))]
    return dict(jcfg=jcfg, cfg=_port_cfg(jcfg), jbuckets=jbuckets,
                buckets=tbuckets, names=names)


@pytest.fixture(scope="module")
def swept(small, tmp_path_factory):
    """An uninterrupted run_sweep over the small buckets."""
    tmp = tmp_path_factory.mktemp("swept")
    rows, res, _ = sweep383.run_sweep(
        small["buckets"], small["names"], small["cfg"],
        str(tmp / "rows.jsonl"), str(tmp / "ckpt"), width=2,
        chunk_steps=CHUNK)
    return dict(rows=rows, res=res, path=tmp / "rows.jsonl")


def _assert_results_equal(got, want, exact_error=False):
    for f in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    err = np.asarray(got.error), np.asarray(want.error)
    if exact_error:
        np.testing.assert_array_equal(*err)
    else:
        np.testing.assert_allclose(*err, rtol=0, atol=1e-5)


def test_a_rows_equal_the_jax_tools_core(small, swept):
    """The JAX tool's loop (tools/sweep383.py:110-137) without its files:
    one JAX register_fused_stream per bucket, reassembled into pool
    order."""
    outs = [(idxs, jfs.register_fused_stream(bp, small["jcfg"], width=2,
                                             chunk_steps=CHUNK))
            for bp, idxs in small["jbuckets"]]
    want = jmeasure._reassemble(outs, len(small["names"]))
    assert np.asarray(want.converged).all()
    _assert_results_equal(swept["res"], want)
    with open(swept["path"]) as fh:
        lines = [json.loads(line) for line in fh]
    assert [list(r) for r in lines] == [FIELDS] * len(small["names"])
    assert lines == swept["rows"]
    for i, r in enumerate(lines):
        assert r["pair"] == small["names"][i]
        assert r["compat"] == int(want.opt_comp[i])
        assert (r["outer"], r["inner"], r["evals"], r["icp_runs"]) == (
            int(want.outer_iters[i]), int(want.inner_iters[i]),
            int(want.evals[i]), int(want.icp_runs[i]))
        assert abs(r["error"] - float(want.error[i])) <= 1e-5


def test_b_stops_resume_across_buckets(small, swept, tmp_path):
    """Stopped after every chunk and resumed each time, a sweep crosses
    both buckets (the first parked in its done file) and lands on the
    uninterrupted rows; once it has finished, cleanup leaves nothing."""
    ckpt = tmp_path / "ckpt"
    stops = 0
    while True:
        try:
            rows, res, _ = sweep383.run_sweep(
                small["buckets"], small["names"], small["cfg"],
                str(tmp_path / "rows.jsonl"), str(ckpt), width=2,
                chunk_steps=CHUNK, kill_after_chunks=1, ckpt_every=4)
            break
        except tfs.StreamStopped:
            stops += 1
            files = sorted(os.listdir(ckpt))
            assert [f for f in files if f.endswith(".npz")
                    and not f.endswith(".done.npz")] in (["b0.npz"],
                                                         ["b1.npz"])
            assert not [f for f in files if f.endswith((".npz.npz", ".tmp"))]
    assert stops >= 2 and os.path.exists(ckpt / "b0.done.npz")
    assert rows == swept["rows"]
    _assert_results_equal(res, swept["res"], exact_error=True)
    sweep383.cleanup(str(ckpt), len(small["buckets"]))
    assert not ckpt.exists()


def _cli(*argv, env=None, device="cpu"):
    """The sweep's command line in a child process, on syn00 and syn01."""
    cmd = [sys.executable, "-m", "goicp_tpu_torch.tools.sweep383",
           "--no-reference", "--n", "2", "--chunk-steps", "4", *argv]
    if device:
        cmd += ["--device", device]
    return subprocess.run(
        cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                 **(env or {})))


@pytest.fixture(scope="module")
def killed(tmp_path_factory):
    """A sweep of syn00 and syn01 stopped after one chunk by a child
    process: (its exit, its checkpoint directory)."""
    tmp = tmp_path_factory.mktemp("killed")
    proc = _cli("--kill-after-chunks", "1", "--out", str(tmp / "rows.jsonl"),
                "--ckpt", str(tmp / "ckpt"))
    return proc, tmp / "ckpt"


def _snapshot(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def _copy(src, dst):
    dst.mkdir()
    for f, b in _snapshot(src).items():
        (dst / f).write_bytes(b)
    return dst


def test_b_cli_stop_exits_3_and_a_fresh_run_resumes(killed, tmp_path):
    proc, ckpt = killed
    assert proc.returncode == 3, proc.stderr
    assert "KILLED (as requested)" in proc.stdout
    assert sorted(os.listdir(ckpt)) == ["b0.npz", "manifest.json",
                                        "walls.json"]
    state, *_ = tfs.load_stream_state(str(ckpt / "b0.npz"), "cpu")
    assert state["it"].shape == (2,)
    resumed = _copy(ckpt, tmp_path / "resumed")
    argv = ["--no-reference", "--n", "2", "--chunk-steps", "4", "--device",
            "cpu"]
    assert sweep383.main(argv + ["--out", str(tmp_path / "resumed.jsonl"),
                                 "--ckpt", str(resumed)]) == 0
    assert not resumed.exists()
    assert sweep383.main(argv + ["--out", str(tmp_path / "whole.jsonl"),
                                 "--ckpt", str(tmp_path / "whole")]) == 0
    assert (tmp_path / "resumed.jsonl").read_text() == \
        (tmp_path / "whole.jsonl").read_text()
    assert not (tmp_path / "whole").exists()


@pytest.mark.parametrize("argv,field", [
    (["--n", "3"], "n"),
    (["--n", "2", "--buckets", "2"], "buckets"),
])
def test_c_manifest_mismatch_raises_and_keeps_the_files(killed, tmp_path,
                                                        argv, field):
    _, ckpt = killed
    mine = _copy(ckpt, tmp_path / "ckpt")
    before = _snapshot(mine)
    with pytest.raises(ValueError, match=rf"\b{field}\b.*differ"):
        sweep383.main(["--no-reference", "--chunk-steps", "4", "--device",
                       "cpu", "--out", str(tmp_path / "rows.jsonl"),
                       "--ckpt", str(mine), *argv])
    assert _snapshot(mine) == before
    assert not (tmp_path / "rows.jsonl").exists()


def test_d_a_real_error_inside_a_bucket_propagates(monkeypatch, tmp_path):
    def launch_failure(*args, **kw):
        raise RuntimeError("CUDA error: unspecified launch failure")
    monkeypatch.setattr(sweep383, "register_fused_stream", launch_failure)
    with pytest.raises(RuntimeError, match="launch failure") as exc:
        sweep383.main(["--no-reference", "--n", "2", "--device", "cpu",
                       "--kill-after-chunks", "1", "--out",
                       str(tmp_path / "rows.jsonl"), "--ckpt",
                       str(tmp_path / "ckpt")])
    assert not isinstance(exc.value, tfs.StreamStopped)


def test_d_without_a_card_the_default_device_fails(tmp_path):
    """No --device on a box without a card: default_device()'s error,
    exit 1, not the stop's 3, even with --kill-after-chunks."""
    proc = _cli("--kill-after-chunks", "1", "--out", str(tmp_path / "r"),
                "--ckpt", str(tmp_path / "ckpt"), device=None,
                env=dict(CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 1, proc.stdout
    assert 'device="cpu"' in proc.stderr
    assert "KILLED" not in proc.stdout
    assert not (tmp_path / "ckpt").exists()


@pytest.mark.parametrize("engine", ["fused_stream", "chunked"])
def test_e_suffixless_checkpoint_is_written_there_and_resumes(small, tmp_path,
                                                              engine):
    pairs, cfg = small["buckets"][1][0], small["cfg"]
    if engine == "fused_stream":
        def run(**kw):
            return tfs.register_fused_stream(pairs, cfg, width=2,
                                             chunk_steps=CHUNK, **kw)
    else:
        def run(**kw):
            return chunked.register_device_batch_compact(pairs, cfg,
                                                         chunk_steps=2, **kw)
    full = run()
    path = tmp_path / "state"
    with pytest.raises(tfs.StreamStopped, match="max_chunks"):
        run(checkpoint_path=str(path), max_chunks=1)
    assert sorted(os.listdir(tmp_path)) == ["state"]
    resumed = run(checkpoint_path=str(path), resume=True)
    _assert_results_equal(resumed, full, exact_error=True)


@pytest.mark.parametrize("engine", ["fused_stream", "chunked"])
def test_e_a_failed_write_keeps_the_previous_checkpoint(monkeypatch,
                                                        tmp_path, engine):
    state = {"it": torch.tensor([3, 4], dtype=torch.int32),
             "converged": torch.tensor([False, True])}
    if engine == "fused_stream":
        def save(path, st):
            tfs.save_stream_state(path, st, [0, 1], [False, False], 2, {})

        def load(path):
            return tfs.load_stream_state(path, "cpu")[0]
    else:
        def save(path, st):
            chunked.save_state(path, st, [0, 1], {})

        def load(path):
            return chunked.load_state(path, "cpu")[0]
    path = str(tmp_path / "state")
    save(path, state)

    def half_written(fh, **blob):
        fh.write(b"PK\x03\x04 a partial archive")
        raise OSError("no space left on device")
    monkeypatch.setattr(np, "savez", half_written)
    with pytest.raises(OSError, match="no space"):
        save(path, {k: v + 1 for k, v in state.items()})
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["state"]
    got = load(path)
    assert torch.equal(got["it"], state["it"])
    assert torch.equal(got["converged"], state["converged"])


@pytest.mark.parametrize("trimmed", [False, True])
def test_f_default_paths_are_ignored_and_not_the_jax_tools(trimmed):
    import fnmatch
    patterns = [line.strip().strip("/")
                for line in (REPO / ".gitignore").read_text().splitlines()
                if line.strip() and not line.startswith("#")]
    jax_tool = {"sweep383.jsonl", "sweep383_trimmed.jsonl"}
    for path in sweep383.default_paths(trimmed):
        rel = os.path.relpath(path, REPO)
        assert rel not in jax_tool and not rel.startswith(".sweep383_similar")
        assert not rel.startswith(".sweep383_trimmed")
        assert any(fnmatch.fnmatch(rel, p) for p in patterns), rel
