"""Single-pair end-to-end pipeline (the equivalent of jly_main.cpp).

Port of goicp_tpu/pipeline/pair.py.  Steps (jly_main.cpp:54-179):
  1. read both cavity .mol2 files (source = data, target = model)
  2. centralize both; common scale = max of the two max-norms; divide
  3. write normalized clouds to cavitiesN/ (and run the search on the
     6-significant-digit quantized coordinates, as the reference's
     write-then-reload does)
  4. load c-FPFH descriptors when cfpfh != 0
  5. build grid fields + chem tables on the device, register (BnB + ICP)
  6. write output.txt and *_rescaled.txt (world-frame transform)
  7. optionally apply the transform to the full protein chain and compute
     RMSD vs the pre-aligned reference protein (jly_main.cpp:158-172)

The load/normalize half (`load_pair_inputs`) and the output/RMSD half
(`finish_pair_run`) are shared with the batched sweep
(pipeline/device_sweep.py), which registers many pairs between them.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.geom.normalize import normalize_pair
from goicp_tpu_torch.geom.rmsd import rmsd as compute_rmsd
from goicp_tpu_torch.geom.transform import rescale_transform
from goicp_tpu_torch.io.cfpfh import cfpfh_path_for_cavity, read_cfpfh
from goicp_tpu_torch.io.mol2 import (apply_transform_protein, get_atom_block,
                                     read_mol_file)
from goicp_tpu_torch.io.output import write_output, write_rescaled
from goicp_tpu_torch.io.xyz import quantize_like_file, write_normalized_cloud
from goicp_tpu_torch.pipeline.prepare import PairData, prepare_pair
from goicp_tpu_torch.search.outer import RegistrationResult, register

# the reference's config keys, echoed by a verbose run (jly_main.cpp:231-269)
_REF_KEYS = ("MSEThresh", "norm", "regularization", "regularizationNeighbors",
             "ponderation", "cfpfh", "regularizationFPFH", "rotMinX",
             "rotMinY", "rotMinZ", "rotWidth", "transMinX", "transMinY",
             "transMinZ", "transWidth", "trimFraction", "distTransSize",
             "distTransExpandFactor")


@dataclasses.dataclass
class PairRunResult:
    registration: RegistrationResult
    R: np.ndarray
    t: np.ndarray
    R_world: np.ndarray
    t_world: np.ndarray
    scale: float
    rmsd: float | None


@dataclasses.dataclass
class PairInputs:
    """Host-side loaded + normalized inputs for one pair."""
    src_n: np.ndarray            # quantized normalized source cloud
    tgt_n: np.ndarray
    src_props: np.ndarray
    tgt_props: np.ndarray
    src_fpfh: np.ndarray | None
    tgt_fpfh: np.ndarray | None
    norm: dict                   # normalize_pair output (means, scale, ...)
    data_file: str
    model_file: str
    pair_id: int


def _cavity_name(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def load_pair_inputs(model_file: str, data_file: str, cfg: GoICPConfig,
                     pair_id: int = 1, out_dir: str | None = None,
                     cfpfh_dir: str | None = None,
                     write_normalized: bool = True) -> PairInputs:
    """Steps 1-4: read, normalize to a common scale, quantize, write
    cavitiesN artifacts, load descriptors."""
    src_coords, src_props = read_mol_file(data_file)
    tgt_coords, tgt_props = read_mol_file(model_file)
    norm = normalize_pair(src_coords, tgt_coords)

    # the reference's write-then-reload text quantization
    src_n = quantize_like_file(norm["source"])
    tgt_n = quantize_like_file(norm["target"])

    if write_normalized and out_dir:
        nd = os.path.join(out_dir, "cavitiesN")
        os.makedirs(nd, exist_ok=True)
        write_normalized_cloud(
            os.path.join(nd, f"{_cavity_name(data_file)}_sim{pair_id}N.xyz"),
            norm["source"], src_props)
        write_normalized_cloud(
            os.path.join(nd, f"{_cavity_name(model_file)}_sim{pair_id}N.xyz"),
            norm["target"], tgt_props)

    src_fpfh = tgt_fpfh = None
    if cfg.cfpfh != 0:
        if not cfpfh_dir:
            raise ValueError("cfpfh != 0 requires cfpfh_dir")
        src_fpfh = read_cfpfh(cfpfh_path_for_cavity(cfpfh_dir, data_file))
        tgt_fpfh = read_cfpfh(cfpfh_path_for_cavity(cfpfh_dir, model_file))

    return PairInputs(src_n=src_n, tgt_n=tgt_n, src_props=src_props,
                      tgt_props=tgt_props, src_fpfh=src_fpfh,
                      tgt_fpfh=tgt_fpfh, norm=norm, data_file=data_file,
                      model_file=model_file, pair_id=pair_id)


def finish_pair_run(inputs: PairInputs, reg: RegistrationResult,
                    output_file: str | None = None,
                    out_dir: str | None = None,
                    chains_dir: str | None = None,
                    ref_proteins_dir: str | None = None) -> PairRunResult:
    """Steps 6-7: rescale to world frame, write outputs, protein RMSD."""
    norm = inputs.norm
    R_world, t_world = rescale_transform(
        reg.R, reg.t, norm["scale"], norm["source_mean"], norm["target_mean"])

    if output_file:
        os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
        write_output(output_file, reg.time_s, reg.R, reg.t, reg.error,
                     reg.compatibilities)
        stem = output_file.rsplit(".", 1)[0]
        write_rescaled(stem + "_rescaled.txt", reg.time_s, R_world, t_world,
                       reg.error)

    # optional protein RMSD path (jly_main.cpp:158-172)
    rmsd_val = None
    if chains_dir and ref_proteins_dir:
        src_id = _cavity_name(inputs.data_file)[:6]
        tgt_id = _cavity_name(inputs.model_file)[:6]
        protein = os.path.join(chains_dir, f"{src_id}_protein.mol2")
        aligned = os.path.join(ref_proteins_dir, f"{src_id}.{tgt_id}",
                               f"aligned_{src_id}_protein.mol2")
        if os.path.exists(protein) and os.path.exists(aligned):
            rot_dir = os.path.join(out_dir or ".", "rot")
            os.makedirs(rot_dir, exist_ok=True)
            rot_path = os.path.join(rot_dir, f"rot_{src_id}_protein.mol2")
            apply_transform_protein(protein, rot_path, R_world, t_world)
            rmsd_val = compute_rmsd(get_atom_block(aligned),
                                    get_atom_block(rot_path))
            if out_dir:
                with open(os.path.join(out_dir, "resultsRMSD.txt"), "a") as fh:
                    fh.write(f"{inputs.pair_id}\t{src_id}\t{tgt_id}\t"
                             f"{rmsd_val:.6f}\n")

    return PairRunResult(registration=reg, R=reg.R, t=reg.t,
                         R_world=R_world, t_world=t_world,
                         scale=norm["scale"], rmsd=rmsd_val)


def run_pair(model_file: str, data_file: str, cfg: GoICPConfig,
             nd_downsampled: int = 0, output_file: str | None = None,
             pair_id: int = 1, out_dir: str | None = None,
             cfpfh_dir: str | None = None, chains_dir: str | None = None,
             ref_proteins_dir: str | None = None,
             write_normalized: bool = True, verbose: bool = False,
             engine: str = "host",
             device: torch.device | str | None = None) -> PairRunResult:
    """model_file: target cavity .mol2; data_file: source cavity .mol2.

    engine: "host" (the host-streaming outer loop, search/outer.py) or
    "device" (search/device_engine.py::register_device).  device: where
    the pair is prepared and searched; None means
    goicp_tpu_torch.default_device(), the card."""
    if engine not in ("host", "device"):
        raise ValueError(f"engine must be 'host' or 'device', not {engine!r}")
    if verbose:
        # console echo of config + inputs (jly_main.cpp:221-269)
        print("CONFIG:")
        d = dataclasses.asdict(cfg)
        for k in _REF_KEYS:
            print(f"({k})->({d[k]})")
        print()
        print("INPUT:")
        print(f"(modelFName)->({model_file})")
        print(f"(dataFName)->({data_file})")
        print(f"(NdDownsampled)->({nd_downsampled})")
        print(f"(outputFName)->({output_file})")
        print(f"(pair)->({pair_id})")
        print()
    inputs = load_pair_inputs(model_file, data_file, cfg, pair_id=pair_id,
                              out_dir=out_dir, cfpfh_dir=cfpfh_dir,
                              write_normalized=write_normalized)
    pair = prepare_pair(inputs.src_n, inputs.tgt_n, inputs.src_props,
                        inputs.tgt_props, cfg, inputs.src_fpfh,
                        inputs.tgt_fpfh, nd_downsampled=nd_downsampled,
                        bucket=True, device=device)
    if engine == "device":
        reg = register_with_device_engine(pair, cfg)
    else:
        reg = register(pair, cfg, verbose=verbose)

    return finish_pair_run(inputs, reg, output_file=output_file,
                           out_dir=out_dir, chains_dir=chains_dir,
                           ref_proteins_dir=ref_proteins_dir)


def result_to_host(res):
    """A DeviceResult (one pair or a batch) with every leaf as numpy."""
    return type(res)(*(t.cpu().numpy() if torch.is_tensor(t)
                       else np.asarray(t) for t in res))


def adapt_device_result(res, n_data: int, time_s: float
                        ) -> RegistrationResult:
    """One pair's DeviceResult row (numpy leaves) -> the host engine's
    RegistrationResult."""
    if np.isnan(float(res.error)):
        # numeric guard: the engines adopt NaN scores infectiously
        # (NaN-propagating comparisons) precisely so that a NaN escaping
        # scoring fails HERE instead of silently vanishing
        raise FloatingPointError(
            "NaN escaped bound/ICP scoring (engine incumbent is NaN)")
    terms = np.asarray(res.terms, np.float64)
    comp = int(res.opt_comp)
    return RegistrationResult(
        error=float(res.error), R=np.asarray(res.R, np.float64),
        t=np.asarray(res.t, np.float64), optComp=comp,
        compatibilities=n_data - comp,
        geom_error=float(terms[0]), incomp_error=float(terms[1]),
        fpfh_error=float(terms[2]), last_icp=bool(res.last_icp),
        time_s=time_s, outer_steps=int(res.outer_iters),
        bound_evals=int(res.evals), icp_runs=int(res.icp_runs),
        gap=float(res.gap), converged=bool(res.converged))


def register_with_device_engine(pair: PairData, cfg: GoICPConfig
                                ) -> RegistrationResult:
    """search/device_engine.py::register_device on a prepared pair, its
    result adapted to the host engine's RegistrationResult.

    The pair's tensors are on its device (and, on a card, the copies have
    finished) BEFORE the registration clock starts: the reported time is
    the search alone, like the reference's registration-only `Time:`,
    whose file and DT loading is likewise outside the clock."""
    from goicp_tpu_torch.search.device_engine import register_device

    if pair.device.type == "cuda":
        torch.cuda.synchronize(pair.device)
    t0 = time.time()
    res = result_to_host(register_device(pair, cfg))
    return adapt_device_result(res, pair.n_data, time.time() - t0)
