"""Normalized point-cloud (.xyz) reading and writing.

Port of goicp_tpu/io/xyz.py.  Format (transformation.cpp:340-350,
jly_main.cpp:289-301):
    line 1: N
    lines 2..N+1: x y z [prop_code]
written with C++ default ostream precision (6 significant digits).  The
reference re-reads the file it just wrote, so the search runs on the
quantized coordinates; `quantize_like_file` reproduces that round trip
without touching disk.
"""

from __future__ import annotations

import numpy as np


def _fmt(v: float) -> str:
    # C++ default ostream: 6 significant digits
    return f"{v:.6g}"


def write_normalized_cloud(path: str, coords: np.ndarray,
                           props: np.ndarray | None = None) -> None:
    with open(path, "w") as fh:
        fh.write(f"{len(coords)}\n")
        for i, row in enumerate(coords):
            line = " ".join(_fmt(float(c)) for c in row)
            if props is not None:
                line += f" {int(props[i])}"
            fh.write(line + "\n")


def read_point_cloud(path: str):
    """Read `N\\nx y z [c]` files. Returns (coords (N,3) f64, props (N,) i64
    or None).

    Header-tolerant: a first line holding a bare integer count is the
    header; otherwise the first line is data (the reference's demo mixes
    headered .txt and raw .xyz clouds).  A missing property column reads
    as 0."""
    with open(path, "r") as fh:
        first = fh.readline().split()
        rows = []
        headered = bool(first) and len(first) <= 2 and first[0].isdigit()
        if not headered and first:
            rows.append(first)
        for line in fh:
            tok = line.split()
            if tok:
                rows.append(tok)
        if headered:
            rows = rows[: int(first[0])]
    coords = np.array([[float(t[0]), float(t[1]), float(t[2])]
                       for t in rows], dtype=np.float64).reshape(-1, 3)
    props = None
    if any(len(t) > 3 for t in rows):
        props = np.array([int(t[3]) if len(t) > 3 else 0 for t in rows],
                         dtype=np.int64)
    return coords, props


def quantize_like_file(coords: np.ndarray) -> np.ndarray:
    """Round-trip coords through the 6-significant-digit text format in
    memory."""
    flat = np.asarray(coords, dtype=np.float64).reshape(-1)
    out = np.array([float(_fmt(float(v))) for v in flat], np.float64)
    return out.reshape(np.shape(coords))
