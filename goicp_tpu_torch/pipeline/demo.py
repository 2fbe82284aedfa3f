"""Stanford bunny / random-points demo (demo/demo.m).

Port of goicp_tpu/pipeline/demo.py.  The demo drives the plain Go-ICP
path: clouds already normalized into [-1,1]^3, no chemistry terms, prefix
downsampling of the data cloud
(`./GoICP model_bunny.txt data_bunny.txt 1000 config.txt output.txt`,
demo/demo.m:22).
"""

from __future__ import annotations

import numpy as np

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.io.output import write_output
from goicp_tpu_torch.io.xyz import read_point_cloud
from goicp_tpu_torch.pipeline.prepare import prepare_pair
from goicp_tpu_torch.search.outer import RegistrationResult, register

# The demo's configuration: plain Go-ICP (no chem terms) on a 300^3 grid,
# two rotation cubes per outer step.  icp_on_improve=0: with batched pops
# the best-of-batch ub improves rarely, so ICP gated on improvement starves
# and the search grinds on; ungated, the per-step ICP reaches the global
# basin within a few steps (the reference fires ICP per single node,
# jly_goicp.cpp:771-854, so its gating never starves).
DEMO_CONFIG = GoICPConfig(
    MSEThresh=0.001, regularization=0.0, regularizationNeighbors=0.0,
    ponderation=0, cfpfh=0, regularizationFPFH=0.0,
    trimFraction=0.0, distTransSize=300, distTransExpandFactor=2.0,
    rot_batch=2, trans_pop=8, trans_capacity=128, icp_on_improve=0)


def run_demo(model_file: str, data_file: str, nd_downsampled: int = 1000,
             cfg: GoICPConfig | None = None, output_file: str | None = None,
             verbose: bool = False, engine: str = "device",
             device=None) -> RegistrationResult:
    """engine "device" (register_device) or "host" (the host-streaming
    engine); device None means goicp_tpu_torch.default_device(), the
    card."""
    from goicp_tpu_torch.pipeline.pair import register_with_device_engine

    cfg = cfg or DEMO_CONFIG
    model, _ = read_point_cloud(model_file)
    data, _ = read_point_cloud(data_file)
    pair = prepare_pair(data, model, np.zeros(len(data), np.int32),
                        np.zeros(len(model), np.int32), cfg,
                        nd_downsampled=nd_downsampled, device=device)
    if engine == "device":
        reg = register_with_device_engine(pair, cfg)
    elif engine == "host":
        reg = register(pair, cfg, verbose=verbose)
    else:
        raise ValueError(f"engine must be 'host' or 'device', not {engine!r}")
    if output_file:
        write_output(output_file, reg.time_s, reg.R, reg.t, reg.error,
                     reg.compatibilities)
    return reg
