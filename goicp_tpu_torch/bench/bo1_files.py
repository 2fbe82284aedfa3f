"""Write a BO1-style data root from synthetic pairs.

The layout the pair runner and the sweeps read (pipeline/sweep.py):

    cavities/<id>_cavity6.mol2          one per cavity
    cfpfh/<id>_cavity6.cfpfh            41 bins per point: zeros, or the
                                        seeded descriptors of
                                        bench/options.py
    chains/<src>_protein.mol2           the data cloud as backbone CA atoms
    ref_proteins/<src>.<tgt>/aligned_<src>_protein.mol2
                                        the same atoms in the model's frame
    cavities_<kind>_BO1_clean.tsv       one row per pair

A pair named NAME (5 characters) becomes source cavity NAMEd and target
cavity NAMEm, so the 6-character ids the RMSD path derives from the cavity
file names are exactly these.  The .mol2 writer is the one the repository
uses to run the reference binary on the bench's pools
(tools/ref_workload_baseline.py), so both read the same files.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from goicp_tpu_torch.chem.properties import PROP_NAMES

_CA = PROP_NAMES.index("CA")


def write_mol2(path: str, coords, prop_idx) -> None:
    """A minimal .mol2 the reference parser reads like the cavity files:
    header lines (the atom count on line 6), an @<TRIPOS>ATOM block whose
    atom names carry the dense property indices, then trailing
    sections."""
    name = os.path.basename(path)
    with open(path, "w") as fh:
        fh.write("#    Name: %s\n#\n\n@<TRIPOS>MOLECULE\n%s\n" % (name, name))
        fh.write("  %d     0     1     0     0\nPROTEIN\nNO_CHARGES\n\n\n"
                 % len(coords))
        fh.write("@<TRIPOS>ATOM\n")
        for i, (p, c) in enumerate(zip(coords, prop_idx)):
            fh.write("%7d %-8s %10.6f %10.6f %10.6f %-8s %3d %-8s %8.4f \n"
                     % (i + 1, PROP_NAMES[int(c)], p[0], p[1], p[2],
                        "X.0", 1, "SYN1", 0.0))
        fh.write("@<TRIPOS>SUBSTRUCTURE\n")
        fh.write("     1 CUB1        1 GROUP        1 X    CUB  0     "
                 "**** CUB X 1\n")
        fh.write("@<TRIPOS>SET\n")


def write_cfpfh(path: str, n: int, descriptors=None) -> None:
    """n rows of 41 zero bins, or the rows of `descriptors` (n, 41)."""
    if descriptors is None:
        descriptors = np.zeros((n, 41))
    with open(path, "w") as fh:
        fh.writelines(" ".join(repr(float(v)) for v in row) + "\n"
                      for row in descriptors[:n])


def write_bo1_root(root: str, pairs, kind: str = "similar",
                   descriptor_seed: int | None = None) -> list:
    """pairs: [(name, data_raw (Nd,3), model_raw (Nm,3), data props,
    model props, aligned (Nd,3) or None)], props as dense indices; aligned
    is the data cloud in the model's frame, written as the RMSD path's
    chain files when given.  descriptor_seed: write each pair's
    options.seeded_descriptors from this seed instead of zero
    descriptors.  Returns the TSV's [(source id, target id)]."""
    from goicp_tpu_torch.bench.options import seeded_descriptors
    for sub in ("cavities", "cfpfh", "chains", "ref_proteins"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rows = []
    for name, data, model, dp, mp, aligned in pairs:
        if len(name) != 5:
            raise ValueError(f"pair names have 5 characters, not {name!r}")
        src, tgt = f"{name}d", f"{name}m"
        desc = (None, None) if descriptor_seed is None \
            else seeded_descriptors(dp, mp, descriptor_seed)
        for cid, coords, props, d in ((src, data, dp, desc[0]),
                                      (tgt, model, mp, desc[1])):
            write_mol2(os.path.join(root, "cavities", f"{cid}_cavity6.mol2"),
                       coords, props)
            write_cfpfh(os.path.join(root, "cfpfh", f"{cid}_cavity6.cfpfh"),
                        len(coords), d)
        if aligned is not None:
            ca = np.full(len(data), _CA)
            write_mol2(os.path.join(root, "chains", f"{src}_protein.mol2"),
                       data, ca)
            ref = os.path.join(root, "ref_proteins", f"{src}.{tgt}")
            os.makedirs(ref, exist_ok=True)
            write_mol2(os.path.join(ref, f"aligned_{src}_protein.mol2"),
                       aligned, ca)
        rows.append((src, tgt))
    with open(os.path.join(root, f"cavities_{kind}_BO1_clean.tsv"),
              "w") as fh:
        for i, (src, tgt) in enumerate(rows):
            fh.write(f"U{2 * i:05d}\tU{2 * i + 1:05d}\t{src}\t{tgt}\t1.0\t"
                     f"synthetic\t0\n")
    return rows


def write_config(path: str, cfg) -> None:
    """Every field of a GoICPConfig as `key=value`, read back exactly by
    GoICPConfig.from_file."""
    with open(path, "w") as fh:
        for f in dataclasses.fields(cfg):
            fh.write(f"{f.name}={getattr(cfg, f.name)!r}\n")
