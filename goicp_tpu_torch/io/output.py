"""GoICP result files: output.txt and *_rescaled.txt
(jly_main.cpp:131-141, transformation.cpp:120-139 and 403-417).

Port of goicp_tpu/io/output.py; the files are byte-identical to the JAX
package's for the same values.
"""

from __future__ import annotations

import numpy as np


def write_output(path: str, time_s: float, R: np.ndarray, t: np.ndarray,
                 error: float, compatibilities: int) -> None:
    """jly_main.cpp:131-141: R and t printed as by the reference's Matrix
    operator<< (right-aligned %11.7f columns)."""
    R = np.asarray(R, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64).reshape(3)
    with open(path, "w") as fh:
        fh.write(f"Time: {_num(time_s)}\n")
        fh.write("Rotation Matrix: \n")
        for i in range(3):
            fh.write(" ".join(f"{R[i, j]:11.7f}" for j in range(3)) + " \n")
        fh.write("Translation Vector: \n")
        for i in range(3):
            fh.write(f"{t[i]:11.7f} \n")
        fh.write(f"Error: {_num(error)}\n")
        fh.write(f"Compatibilities: {compatibilities}\n")


def write_rescaled(path: str, time_s: float, R: np.ndarray,
                   t_world: np.ndarray, error: float) -> None:
    """transformation.cpp:403-417: values in the default 6-significant-digit
    ostream format."""
    R = np.asarray(R, dtype=np.float64)
    t = np.asarray(t_world, dtype=np.float64).reshape(3)
    with open(path, "w") as fh:
        fh.write(f"Time: {_num(time_s)}\n")
        fh.write("Rotation Matrix:\n")
        for i in range(3):
            fh.write("   " + "   ".join(_num(R[i, j]) for j in range(3))
                     + "\n")
        fh.write("Translation Vector:\n")
        for i in range(3):
            fh.write(f"   {_num(t[i])}\n")
        fh.write(f"Error: {_num(error)}\n")


def read_output(path: str):
    """Parse either output format. Returns dict with time, R (3,3), t (3,),
    error, compatibilities (or None)."""
    with open(path, "r") as fh:
        tokens = fh.read().split()
    vals = {}
    nums = []
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok == "Time:":
            vals["time"] = float(tokens[i + 1])
            i += 2
        elif tok == "Error:":
            vals["error"] = float(tokens[i + 1])
            i += 2
        elif tok == "Compatibilities:":
            vals["compatibilities"] = int(tokens[i + 1])
            i += 2
        else:
            try:
                nums.append(float(tok))
            except ValueError:
                pass
            i += 1
    arr = np.array(nums[:12], dtype=np.float64)
    vals["R"] = arr[:9].reshape(3, 3)
    vals["t"] = arr[9:12]
    vals.setdefault("compatibilities", None)
    return vals


def _num(v: float) -> str:
    return f"{v:.6g}"
