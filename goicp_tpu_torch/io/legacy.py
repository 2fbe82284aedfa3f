"""Legacy readers of the reference's older data layouts
(transformation.cpp:194-277).

Port of goicp_tpu/io/legacy.py: .pcd cavity files (xyzc after a 10-line
header), readme-style pair lists for pcd files, and the mol-list TSV
variant.
"""

from __future__ import annotations

import numpy as np


def read_pcd_file(path: str):
    """readPCDfile (transformation.cpp:236-254): skip a 10-line header, then
    `x y z c` rows. Returns (coords (N,3) f64, props (N,) i64)."""
    coords, props = [], []
    with open(path, "r") as fh:
        lines = fh.readlines()[10:]
    for line in lines:
        tok = line.split()
        if len(tok) < 4:
            continue
        coords.append((float(tok[0]), float(tok[1]), float(tok[2])))
        props.append(int(float(tok[3])))
    return (np.asarray(coords, dtype=np.float64),
            np.asarray(props, dtype=np.int64))


def read_config_protein_file(path: str):
    """readConfigProteinFile (transformation.cpp:194-231): skip 11 header
    lines, then tab-separated name pairs until a blank line (similar),
    skip one line, then pairs until blank (dissimilar)."""
    with open(path, "r") as fh:
        lines = fh.read().split("\n")[11:]
    similar, dissimilar = [], []
    bucket = similar
    skipped_separator = False
    for line in lines:
        if not line.strip():
            if bucket is similar and not skipped_separator:
                bucket = dissimilar
                skipped_separator = True
                continue
            break
        parts = [p.strip().replace(" ", "") for p in line.split("\t")
                 if p.strip()]
        if len(parts) >= 2:
            bucket.extend(parts[:2])
    return similar, dissimilar


def read_config_mol_file(path: str):
    """readConfigMolFile (transformation.cpp:259-277): tab-separated rows;
    columns 2, 3 become `<id>_cavity6.mol2` names."""
    cavities = []
    with open(path, "r") as fh:
        for line in fh:
            if not line.strip():
                break
            tok = line.split("\t")
            if len(tok) >= 4:
                cavities.append(tok[2].strip() + "_cavity6.mol2")
                cavities.append(tok[3].strip() + "_cavity6.mol2")
    return cavities
