"""BO1 pair list parsing (bo1_GoICP.py:9-27).

Port of goicp_tpu/io/tsv.py.  Each row: uniprot_src uniprot_tgt cavity_src
cavity_tgt score family cluster.  Columns 2, 3 (0-based) are the cavity
ids; the sweep registers source=<col2>_cavity6.mol2 onto
target=<col3>_cavity6.mol2.  The list ends at the first blank line.
"""

from __future__ import annotations


def read_pair_list(path: str):
    """Returns list of (source_cavity_id, target_cavity_id) tuples."""
    pairs = []
    with open(path, "r") as fh:
        for line in fh:
            if not line.strip():
                break
            tok = line.split()
            pairs.append((tok[2], tok[3]))
    return pairs
