"""Physico-chemical atom properties.

Port of the parts of goicp_tpu/chem/properties.py the port uses.  The
reference encodes 9 atom-name-derived properties
as integer codes (the .mol2 readers return them, normalized .xyz files
store them); the search uses dense indices 0..8 in the order below.
"""

from __future__ import annotations

import numpy as np

# name -> raw code, in dense-index order
PROP_CODES = {
    "OG": 8204959,
    "N": 30894,
    "O": 15219528,
    "NZ": 15231913,
    "CZ": 4646984,
    "CA": 16741671,
    "DU": 7566712,
    "OD1": 0,
    "C": 1,
}
PROP_NAMES = list(PROP_CODES)                 # dense-index order, OG..C
NUM_PROPS = len(PROP_CODES)                   # 9
PROP_INDEX = {name: i for i, name in enumerate(PROP_CODES)}
CODE_TO_INDEX = {code: i for i, code in enumerate(PROP_CODES.values())}

# the protein-backbone properties RMSD is computed over
RMSD_PROPS = frozenset({PROP_CODES["C"], PROP_CODES["CA"], PROP_CODES["N"],
                        PROP_CODES["O"]})


def string_to_prop(name: str) -> int:
    """Atom name -> raw property code; unknown names fall back to OG."""
    return PROP_CODES.get(name, PROP_CODES["OG"])


def string_to_index(name: str) -> int:
    """Atom name -> dense property index 0..8; unknown names fall back to
    OG (0)."""
    return PROP_INDEX.get(name, PROP_INDEX["OG"])


def codes_to_indices(codes: np.ndarray) -> np.ndarray:
    """Raw property codes -> dense indices. Unknown codes map to OG (0)."""
    return np.array([CODE_TO_INDEX.get(int(c), 0)
                     for c in np.asarray(codes).astype(np.int64)],
                    dtype=np.int32)


def compatibility_matrix() -> np.ndarray:
    """(NUM_PROPS, NUM_PROPS) bool matrix compat[src, tgt]: the reference's
    identity-only map."""
    return np.eye(NUM_PROPS, dtype=bool)
