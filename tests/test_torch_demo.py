"""The port's demo (goicp_tpu_torch/pipeline/demo.py) through
`goicp_tpu_torch.cli run-demo --device cpu` vs the JAX package's run_demo,
on a small random cloud pair in read_point_cloud's `N\\nx y z` format and
a small grid (the demo's own 300^3 grid is for the card)."""

import dataclasses

import numpy as np
import torch

from goicp_tpu.config import GoICPConfig as JConfig
from goicp_tpu.pipeline import demo as jdemo
from goicp_tpu_torch import cli
from goicp_tpu_torch.bench import bo1_files
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.geom.rotation import rodrigues_np
from goicp_tpu_torch.io.output import read_output
from goicp_tpu_torch.io.xyz import write_normalized_cloud

torch.set_num_threads(1)


def test_run_demo_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    model = rng.uniform(-0.7, 0.7, (64, 3))
    data = (model[:40] - [0.05, -0.1, 0.08]) @ rodrigues_np(
        np.array([1.9, -0.7, 0.4]))
    for name, cloud in (("model.txt", model), ("data.txt", data)):
        write_normalized_cloud(str(tmp_path / name), cloud)
    cfg = dataclasses.replace(GoICPConfig(), MSEThresh=0.001,
                              regularization=0.0, ponderation=0,
                              distTransSize=16, rot_batch=2, trans_pop=4,
                              trans_capacity=32, icp_on_improve=0,
                              device_rot_capacity=256)
    config = str(tmp_path / "demo.txt")
    bo1_files.write_config(config, cfg)
    want = jdemo.run_demo(str(tmp_path / "model.txt"),
                          str(tmp_path / "data.txt"), 30,
                          JConfig.from_file(config))
    out = str(tmp_path / "output.txt")
    assert cli.main(["run-demo", str(tmp_path / "model.txt"),
                     str(tmp_path / "data.txt"), "30", "--config", config,
                     "--output", out, "--device", "cpu", "-q"]) == 0
    got = read_output(out)
    assert want.converged and abs(got["error"] - want.error) <= 1e-5
    np.testing.assert_allclose(got["R"], want.R, atol=1e-4)
    np.testing.assert_allclose(got["t"], want.t, atol=1e-4)
    assert got["compatibilities"] == want.compatibilities == 30
