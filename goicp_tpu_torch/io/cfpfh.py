"""c-FPFH descriptor files: one row of 41 floats per point
(jly_main.cpp:292-310; files cfpfh/<cavity>.cfpfh).

Port of goicp_tpu/io/cfpfh.py.  The `cfpfh` config knob picks which bins
the chem term compares (jly_goicp.cpp:1626-1640): 1 -> bins 0..40 (full
c-FPFH), 2 -> 0..32 (FPFH only), 3 -> 33..40 (colour histogram only).
"""

from __future__ import annotations

import os

import numpy as np

from goicp_tpu_torch import native

NUM_BINS = 41
_MAX_VALS = 1 << 24


def read_cfpfh(path: str) -> np.ndarray:
    """(N, 41) float64 descriptors, parsed by the native float-table
    parser; a file whose value count is not a positive multiple of 41
    raises ValueError."""
    vals = native.parse_float_table(path, _MAX_VALS)
    if not len(vals) or len(vals) % NUM_BINS:
        raise ValueError(f"{path}: expected rows of {NUM_BINS} bins, got "
                         f"{len(vals)} values")
    return vals.reshape(-1, NUM_BINS)


def cfpfh_path_for_cavity(cfpfh_dir: str, cavity_file: str) -> str:
    """The descriptor file of a cavity file, named the way loadPointCloud
    does (jly_main.cpp:279): strip the directory and `.mol2`, or the
    trailing `_simKN.xyz` suffix.

    e.g. cavitiesN/2x86_3_cavity6_sim1N.xyz -> cfpfh/2x86_3_cavity6.cfpfh
         cavities/2x86_3_cavity6.mol2        -> cfpfh/2x86_3_cavity6.cfpfh
    """
    base = os.path.basename(cavity_file)
    if base.endswith(".mol2"):
        stem = base[: -len(".mol2")]
    else:
        stem = base.rsplit("_", 1)[0]
    return os.path.join(cfpfh_dir, stem + ".cfpfh")


def select_bins(desc: np.ndarray, cfpfh_mode: int) -> np.ndarray:
    if cfpfh_mode in (0, 1):
        return desc
    if cfpfh_mode == 2:
        return desc[:, 0:33]
    if cfpfh_mode == 3:
        return desc[:, 33:41]
    raise ValueError(f"bad cfpfh mode {cfpfh_mode}")
