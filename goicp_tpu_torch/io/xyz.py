"""The reference's normalized-cloud text round trip.

Port of goicp_tpu/io/xyz.py::quantize_like_file.  The reference writes the
normalized clouds with C++ default ostream precision (6 significant
digits) and re-reads them, so the search runs on quantized coordinates.
"""

from __future__ import annotations

import numpy as np


def quantize_like_file(coords: np.ndarray) -> np.ndarray:
    """Round-trip coords through the 6-significant-digit text format in
    memory."""
    flat = np.asarray(coords, dtype=np.float64).reshape(-1)
    out = np.array([float(f"{float(v):.6g}") for v in flat], np.float64)
    return out.reshape(np.shape(coords))
