"""mol2 cavity / protein parsing and writing.

Port of goicp_tpu/io/mol2.py (host-side numpy I/O).  Behaviour mirrors the
reference's token-stream readers:
  * readMolFile (transformation.cpp:282-306): all rows of the @<TRIPOS>ATOM
    block -> (coords, property code from atom name).
  * getAtomBlock (transformation.cpp:423-448): same, filtered to the
    backbone properties {C, CA, N, O} for RMSD.
  * applyTransformationProtein (transformation.cpp:469-539): rewrite the
    ATOM block coordinates of a protein mol2 with a rigid transform,
    preserving all other lines.
"""

from __future__ import annotations

import numpy as np

from goicp_tpu_torch import native
from goicp_tpu_torch.chem.properties import RMSD_PROPS, string_to_prop


def read_mol_file(path: str):
    """Parse the @<TRIPOS>ATOM block of a .mol2 file with the native parser
    (native/parsers.cpp).  Returns (coords float64 (N,3), props int64 (N,)
    raw property codes)."""
    coords, names = native.parse_mol2_atoms(path)
    return coords, np.array([string_to_prop(n) for n in names],
                            dtype=np.int64)


def get_atom_block(path: str):
    """ATOM-block points filtered to backbone props {C, CA, N, O}
    (transformation.cpp:423-448). Returns coords float64 (N,3)."""
    coords, props = read_mol_file(path)
    mask = np.array([int(p) in RMSD_PROPS for p in props], dtype=bool)
    return coords[mask]


def mol2_atom_count(path: str) -> int:
    """Atom count from the MOLECULE header (line 6 of the cavity files), the
    reference sweep's NdDownsampled (bo1_GoICP.py:47)."""
    with open(path, "r") as fh:
        lines = [fh.readline() for _ in range(6)]
    return int(lines[5].split()[0])


def apply_transform_protein(protein_path: str, out_path: str,
                            R: np.ndarray, t: np.ndarray) -> None:
    """Rewrite the ATOM block of `protein_path` with coordinates R@p + t,
    preserving every other line (transformation.cpp:469-539).

    Coordinates are written with 6 decimals, fixed (C's to_string), and the
    columns re-joined with tabs, as the reference does."""
    R = np.asarray(R, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64).reshape(3)
    out_lines = []
    in_atoms = False
    with open(protein_path, "r") as fh:
        for line in fh:
            s = line.rstrip("\n")
            stripped = s.strip()
            if stripped.startswith("@<TRIPOS>"):
                in_atoms = stripped == "@<TRIPOS>ATOM"
                out_lines.append(s)
                continue
            if not in_atoms or not stripped:
                out_lines.append(s)
                continue
            tok = stripped.split()
            if len(tok) < 9:
                out_lines.append(s)
                continue
            p = np.array([float(tok[2]), float(tok[3]), float(tok[4])])
            q = R @ p + t
            tok[2] = f"{q[0]:.6f}"
            tok[3] = f"{q[1]:.6f}"
            tok[4] = f"{q[2]:.6f}"
            out_lines.append("\t".join(tok[:9]))
    with open(out_path, "w") as fh:
        fh.write("\n".join(out_lines) + "\n")
