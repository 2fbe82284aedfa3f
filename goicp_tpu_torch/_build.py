"""Build the CUDA kernels of `csrc/` into one shared library and load it.

nvcc compiles every `csrc/*.cu` for sm_90a into a library with a plain C
interface, which is loaded with ctypes: tensors pass as device pointers
(`data_ptr()`) and the stream as `torch.cuda.current_stream().cuda_stream`,
all as `c_void_p`.  The library lands in `goicp_tpu_torch/_build/`, named
by a hash of the sources and flags, so the first use builds it and later
uses load it.  Only the repository's own sources are compiled, and there
is no fast-math: sqrt and division stay IEEE.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None
build_info: dict = {}    # path, seconds (0 when loaded from the cache), log

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # pts, centers, widths, rot_unc, weights, cells, nearest_cell, consts,
    # trim_count, out0, out1, out2, L, B, Nd, C, size, norm, fused, trim_k,
    # stream
    "goicp_geom_bounds": [_P] * 12 + [_I] * 8 + [_P],
    # pts, corners, cell_compat, prop_onehot, data_mask, nearest_cell,
    # consts, out, L, Q, Nd, C, size, stream
    "goicp_chem_incomp": [_P] * 8 + [_I] * 5 + [_P],
    # pts, centers, widths, rot_unc, weights, cells, nearest_cell, consts,
    # trim_count, lane_pair, out0, out1, out2, L, B, Nd, C, size, norm,
    # stream
    "goicp_geom_bounds_lanes": [_P] * 13 + [_I] * 6 + [_P],
    # pts, corners, cell_compat, prop_onehot, data_mask, nearest_cell,
    # consts, lane_pair, out, L, Q, Nd, C, size, stream
    "goicp_chem_incomp_lanes": [_P] * 9 + [_I] * 5 + [_P],
    # stream
    "goicp_empty_launch": [_P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library(ptxas_verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  ptxas_verbose
    adds `-Xptxas -v` (registers, shared memory and spills per kernel) to
    the build, whose log is kept in build_info["log"]."""
    global _lib
    if _lib is not None:
        return _lib
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if ptxas_verbose else ())
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    out = BUILD_DIR / f"libgoicp_kernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      log=log)
    _lib = lib
    return lib
