"""The port's user entry points (goicp_tpu_torch/cli.py, pipeline/pair.py,
pipeline/sweep.py, pipeline/device_sweep.py) vs the JAX
package's, on a BO1-style data root of two small synthetic pairs written
in a temporary directory (bench/bo1_files.py).  Each source cavity is a
rigidly moved subset of its target, so the protein RMSD path has an exact
answer (0).  The port runs with --device cpu; without it the CLI asks for
the card."""

import json
import os

import numpy as np
import pytest
import torch

from goicp_tpu.config import GoICPConfig as JConfig
from goicp_tpu.pipeline import pair as jpair
from goicp_tpu.pipeline.sweep import run_sweep as jrun_sweep
from goicp_tpu_torch import cli
from goicp_tpu_torch.bench import bo1_files
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.geom.rotation import rodrigues_np
from goicp_tpu_torch.io.output import read_output
from goicp_tpu_torch.pipeline import pair as tpair
from goicp_tpu_torch.search.device_engine import DeviceResult

torch.set_num_threads(1)

_CFG = dict(distTransSize=16, rot_batch=2, trans_capacity=32, trans_pop=4,
            inner_max_iters=60, icp_max_iter=50, device_rot_capacity=256)
_COUNTERS = ("outer_steps", "bound_evals", "icp_runs", "compatibilities",
             "converged")


def _pair(seed, nm, nd):
    """World-frame clouds: data = a rigidly moved subset of the model."""
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.7, 0.7, (nm, 3)) * 12.0 + [30.0, -5.0, 60.0]
    R = rodrigues_np(rng.uniform(-2.5, 2.5, 3))
    sel = rng.permutation(nm)[:nd]
    data = (model[sel] - rng.uniform(-2, 2, 3)) @ R + [-3.0, 4.0, 1.0]
    mp = rng.integers(0, 9, nm)
    return (f"tst{seed:02d}", np.round(data, 6), np.round(model, 6),
            mp[sel], mp, np.round(model[sel], 6))


@pytest.fixture(scope="module")
def bo1(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bo1"))
    ids = bo1_files.write_bo1_root(root, [_pair(10, 48, 40),
                                          _pair(11, 56, 48)])
    config = os.path.join(root, "config.txt")
    bo1_files.write_config(config, GoICPConfig(**_CFG))
    return root, config, ids


@pytest.fixture(scope="module")
def jax_rows(bo1, tmp_path_factory):
    """The JAX package's sweep rows of both pairs, per engine."""
    root, _, _ = bo1
    out = {}
    for engine in ("host", "device"):
        rows = jrun_sweep(root, JConfig(**_CFG),
                          str(tmp_path_factory.mktemp(f"jax_{engine}")),
                          engine=engine)
        out[engine] = {r["pair"]: r for r in rows}
    return out


def _rows(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_cli_help(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--help"])
    assert exc.value.code == 0
    for cmd in ("run-pair", "run-bo1", "run-demo"):
        with pytest.raises(SystemExit):
            cli.main([cmd, "--help"])
        assert "--device" in capsys.readouterr().out


@pytest.mark.parametrize("engine", ["host", "device", "fused"])
def test_run_bo1_matches_jax_and_resumes(bo1, jax_rows, tmp_path, engine):
    root, config, ids = bo1
    out = str(tmp_path / "out")
    argv = ["run-bo1", root, config, "--out-dir", out, "--engine", engine,
            "--device", "cpu", "-q"]
    assert cli.main(argv) == 0
    rows = _rows(os.path.join(out, "results_similar.jsonl"))
    assert [(r["source"], r["target"]) for r in rows] == ids
    # the fused stream's trajectories are register_device's
    want = jax_rows["device" if engine == "fused" else engine]
    for r in rows:
        w = want[r["pair"]]
        assert abs(r["error"] - w["error"]) <= 1e-5
        for k in ("outer_steps", "bound_evals", "compatibilities",
                  "converged"):
            assert r[k] == w[k], k
        if "icp_runs" in w:
            assert r["icp_runs"] == w["icp_runs"]
        assert r["rmsd"] < 1e-4 and abs(r["rmsd"] - w["rmsd"]) < 1e-5
        k = r["pair"]
        assert os.path.exists(os.path.join(out, "output", f"similar{k}.txt"))
        assert os.path.exists(os.path.join(out, "output",
                                           f"similar{k}_rescaled.txt"))
    with open(os.path.join(out, "resultsRMSD.txt")) as fh:
        assert len(fh.readlines()) == 2
    assert cli.main(argv) == 0                     # resume: both skipped
    assert len(_rows(os.path.join(out, "results_similar.jsonl"))) == 2


@pytest.mark.parametrize("engine", ["host", "device"])
def test_run_pair_matches_jax(bo1, jax_rows, tmp_path, engine):
    root, config, ((src, tgt), _) = bo1
    model = os.path.join(root, "cavities", f"{tgt}_cavity6.mol2")
    data = os.path.join(root, "cavities", f"{src}_cavity6.mol2")
    common = dict(chains_dir=os.path.join(root, "chains"),
                  ref_proteins_dir=os.path.join(root, "ref_proteins"))
    want = jpair.run_pair(model, data, JConfig(**_CFG), nd_downsampled=40,
                          output_file=str(tmp_path / "j" / "similar1.txt"),
                          out_dir=str(tmp_path / "j"), engine=engine,
                          **common)
    tout = str(tmp_path / "t")
    assert cli.main(["run-pair", model, data, "40", config,
                     os.path.join(tout, "similar1.txt"), "1", "--out-dir",
                     tout, "--chains-dir", common["chains_dir"],
                     "--ref-proteins-dir", common["ref_proteins_dir"],
                     "--engine", engine, "--device", "cpu", "-q"]) == 0
    got = tpair.run_pair(model, data, GoICPConfig(**_CFG), nd_downsampled=40,
                         out_dir=str(tmp_path / "api"), engine=engine,
                         device="cpu", **common)
    for k in _COUNTERS:
        assert getattr(got.registration, k) == \
            getattr(want.registration, k), k
    assert abs(got.registration.error - want.registration.error) <= 1e-5
    np.testing.assert_allclose(got.R_world, want.R_world, atol=1e-4)
    np.testing.assert_allclose(got.t_world, want.t_world, atol=1e-3)
    assert got.rmsd < 1e-4 and abs(got.rmsd - want.rmsd) < 1e-5
    assert got.scale == want.scale
    # the CLI's files: normalized clouds byte-equal, results equal
    for name in (f"{src}_cavity6_sim1N.xyz", f"{tgt}_cavity6_sim1N.xyz"):
        with open(os.path.join(tout, "cavitiesN", name), "rb") as a, \
                open(tmp_path / "j" / "cavitiesN" / name, "rb") as b:
            assert a.read() == b.read()
    for name, tol in (("similar1.txt", 1e-4), ("similar1_rescaled.txt",
                                                1e-3)):
        a = read_output(os.path.join(tout, name))
        b = read_output(str(tmp_path / "j" / name))
        assert a["compatibilities"] == b["compatibilities"]
        np.testing.assert_allclose(a["R"], b["R"], atol=1e-4)
        np.testing.assert_allclose(a["t"], b["t"], atol=tol)
        assert abs(a["error"] - b["error"]) <= 1e-5
    with open(os.path.join(tout, "resultsRMSD.txt")) as fh:
        assert fh.read().startswith(f"1\t{src}\t{tgt}\t")


def test_cli_wants_the_card_by_default(bo1, tmp_path):
    """No --device: the card, and without one an error, not the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    root, config, _ = bo1
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["run-bo1", root, config, "--out-dir", str(tmp_path),
                  "--engine", "device", "--limit", "1", "-q"])


def test_device_batch_runner_is_not_ported(bo1, tmp_path):
    """run-bo1 --engine device-batch runs the compacting batch runner: its
    rows equal the JAX sweep's device-batch rows and the port's fused
    rows, and a second run skips both pairs."""
    root, config, ids = bo1
    want = {r["pair"]: r for r in jrun_sweep(
        root, JConfig(**_CFG), str(tmp_path / "jax"), engine="device-batch")}
    rows = {}
    for engine in ("device-batch", "fused"):
        out = str(tmp_path / engine)
        argv = ["run-bo1", root, config, "--out-dir", out, "--engine",
                engine, "--device", "cpu", "-q"]
        assert cli.main(argv) == 0
        rows[engine] = _rows(os.path.join(out, "results_similar.jsonl"))
        if engine == "device-batch":
            assert cli.main(argv) == 0          # resume: both skipped
            assert len(_rows(os.path.join(
                out, "results_similar.jsonl"))) == 2
    batch, fused = rows["device-batch"], rows["fused"]
    assert [(r["source"], r["target"]) for r in batch] == ids
    for r, f in zip(batch, fused):
        w = want[r["pair"]]
        assert r["engine"] == w["engine"] == "device-batch"
        assert r["batch"] == w["batch"] == 2
        assert abs(r["error"] - w["error"]) <= 1e-5
        assert abs(r["error"] - f["error"]) <= 1e-5
        for k in ("outer_steps", "bound_evals", "compatibilities",
                  "converged"):
            assert r[k] == w[k] == f[k], k
        assert r["icp_runs"] == f["icp_runs"]
        assert r["rmsd"] < 1e-4 and abs(r["rmsd"] - w["rmsd"]) < 1e-5
        assert os.path.exists(os.path.join(str(tmp_path / "device-batch"),
                                           "output",
                                           f"similar{r['pair']}.txt"))


def test_register_batch_equals_register_device():
    """pipeline/batch_sweep.py: static same-bucket pairs through the fused
    stream, each result equal to its own register_device run."""
    from goicp_tpu_torch.geom.normalize import normalize_pair
    from goicp_tpu_torch.pipeline.batch_sweep import register_batch
    from goicp_tpu_torch.pipeline.prepare import (make_count_dynamic,
                                                  prepare_pair)
    from goicp_tpu_torch.search.device_engine import register_device
    cfg = GoICPConfig(**_CFG)
    pairs = []
    for seed in (3, 4):
        _, data, model, dp, mp, _ = _pair(seed, 36, 28)
        norm = normalize_pair(data, model)
        pairs.append(prepare_pair(norm["source"], norm["target"], dp, mp,
                                  cfg, pad_data_to=32, pad_model_to=64,
                                  pad_cells=64, pad_points=8, device="cpu"))
    got = register_batch(pairs, cfg, slots=2)
    for pair, g in zip(pairs, got):
        w = tpair.adapt_device_result(
            tpair.result_to_host(register_device(pair, cfg)), pair.n_data,
            0.0)
        assert abs(g.error - w.error) <= 1e-5
        for k in _COUNTERS:
            assert getattr(g, k) == getattr(w, k), k
    with pytest.raises(ValueError, match="static pairs"):
        register_batch([make_count_dynamic(p) for p in pairs], cfg)


def test_nan_reaching_adapt_device_result_raises():
    row = DeviceResult(
        error=np.float32(np.nan), R=np.eye(3, dtype=np.float32),
        t=np.zeros(3, np.float32), opt_comp=np.int32(0),
        terms=np.zeros(3, np.float32), last_icp=np.bool_(False),
        outer_iters=3, evals=np.int32(10), gap=np.float32(0.0),
        converged=np.bool_(True), inner_iters=np.int32(4),
        icp_runs=np.int32(1))
    with pytest.raises(FloatingPointError):
        tpair.adapt_device_result(row, 40, 0.1)
    ok = tpair.adapt_device_result(row._replace(error=np.float32(1.5)), 40,
                                   0.1)
    assert (ok.error, ok.compatibilities, ok.outer_steps) == (1.5, 40, 3)
