"""c-FPFH descriptor bin selection.

Port of goicp_tpu/io/cfpfh.py::select_bins.  A descriptor row holds 41
bins; the `cfpfh` config knob picks which of them the chem term compares:
1 -> bins 0..40 (full c-FPFH), 2 -> 0..32 (FPFH only), 3 -> 33..40 (colour
histogram only).  Reading descriptor files comes with the pair runner.
"""

from __future__ import annotations

import numpy as np


def select_bins(desc: np.ndarray, cfpfh_mode: int) -> np.ndarray:
    if cfpfh_mode in (0, 1):
        return desc
    if cfpfh_mode == 2:
        return desc[:, 0:33]
    if cfpfh_mode == 3:
        return desc[:, 33:41]
    raise ValueError(f"bad cfpfh mode {cfpfh_mode}")
