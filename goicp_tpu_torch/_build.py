"""Build the CUDA kernels of `csrc/` into one shared library and load it;
build the host C++ runtime of `native/` the same way (`host_library`).

nvcc compiles every `csrc/*.cu` for sm_90a (one process per source, all
at once) and links them into a library with a plain C interface, which
is loaded with ctypes: tensors pass as device pointers (`data_ptr()`)
and the stream as the current stream's handle, Python ints declared
`c_void_p`.  The library lands in `goicp_tpu_torch/_build/`, named by a
hash of the sources and flags, so the first use builds it and later
uses load it.  Only the repository's own sources are compiled, and there
is no fast-math: sqrt and division stay IEEE.  A failed build raises; no
caller falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import fcntl
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
# ptxas's report (registers, stack frame, spills per kernel) in every
# kernel build's log
PTXAS_LOG = ("-Xptxas", "-v")

HOST_SRC = _PKG / "native"
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-Wall")

_lib = None
_host_lib = None
build_info: dict = {}    # path, seconds (0 when loaded from the cache), log

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
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
    # x, out, rows, n, inner, lanes, stream
    "goicp_ordered_sum": [_P, _P, _L, _I, _L, _I, _P],
    # R, points, t (NULL: none), out, batch, points, stream
    "goicp_rotate": [_P, _P, _P, _P, _L, _I, _P],
    # points, model, out, rows, model points, stream
    "goicp_sq_dist3": [_P, _P, _P, _L, _I, _P],
    # mats, out, batch, stream
    "goicp_det3": [_P, _P, _L, _P],
    # a, b, out, meta (15 int64: sizes, strides, last axis), stream
    "goicp_cross3": [_P, _P, _P, ctypes.POINTER(_L), _P],
    "goicp_dot_fma": [_P, _P, _P, ctypes.POINTER(_L), _P],
    # v, out, rows, stream
    "goicp_norm3": [_P, _P, _L, _P],
    # x, sin, cos, n, stream
    "goicp_sincos32": [_P, _P, _P, _L, _P],
    # v, R, vectors, stream
    "goicp_rodrigues": [_P, _P, _L, _P],
    # widths, norms, out, lanes, points, stream
    "goicp_rot_uncertainty": [_P, _P, _P, _L, _L, _P],
    # data, model, R0, t0, data_mask, count, enabled, workspace, R, t,
    # nn_idx, err, iters, K, Nd, M, inlier_num, max_iter, mode, err_diff,
    # stream
    "goicp_icp_run": [_P] * 13 + [_I] * 6 + [ctypes.c_float, _P],
    # H, R, batch, stream
    "goicp_kabsch3": [_P, _P, _L, _P],
    # slots (15 pointers: bounds/error.py::_SLOTS), ints (14), floats (4),
    # R, t, nn_idx (NULL: none), nn_idx int64, out, rows, mode, stream
    "goicp_score": [ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(_I),
                    ctypes.POINTER(ctypes.c_float), _P, _P, _P, _I, _P, _L,
                    _I, _P],
    # slots, ints, floats (goicp_score's), R, t, nn_idx, nn_idx int64, K,
    # cand_R, cand_t (NULL: the initial route), out (7 pointers), j,
    # route, ws, ticket, stream
    "goicp_score_pick": [ctypes.POINTER(ctypes.c_ulonglong),
                         ctypes.POINTER(_I), ctypes.POINTER(ctypes.c_float),
                         _P, _P, _P, _I, _L, _P, _P,
                         ctypes.POINTER(ctypes.c_ulonglong), _I, _I, _P, _P,
                         _P],
    # slots (21 a row: search/pick.py::_refine_tensors), j (the rows'
    # record rows), n, ints (20), floats (5), record (7 pointers), its
    # rows, rows_ws, tickets, enabled, workspace, stream
    "goicp_icp_refine": [ctypes.POINTER(ctypes.c_ulonglong),
                         ctypes.POINTER(_I), _I, ctypes.POINTER(_I),
                         ctypes.POINTER(ctypes.c_float),
                         ctypes.POINTER(ctypes.c_ulonglong), _I, _P, _P, _P,
                         _P, _P],
    # slots (15: bounds/error.py::_SLOTS), ints (20, goicp_icp_refine's),
    # floats (5), model, R0, t0, out (7 pointers: the state's), words,
    # ticket, workspace, stream
    "goicp_icp_init": [ctypes.POINTER(ctypes.c_ulonglong),
                       ctypes.POINTER(_I), ctypes.POINTER(ctypes.c_float),
                       _P, _P, _P, ctypes.POINTER(ctypes.c_ulonglong), _P,
                       _P, _P, _P],
    # ubs, R_lanes, nodes, seed_R, seed_t, L, K, record (7 pointers or
    # NULL), its rows, stream
    "goicp_icp_seeds": [_P, _P, _P, _P, _P, _L, _I,
                        ctypes.POINTER(ctypes.c_ulonglong), _I, _P],
    # pts, rot_unc, weights, cells, nearest_cell, consts, trim_count,
    # cell_compat, prop_onehot, data_mask, lane_pair, sse; nodes, lbs,
    # cvals, opt_err, thr, best_node, ub_terms, min_dropped, done, live;
    # it, evals, geom_surv, chem_corners in; the 8 float outputs, done,
    # stats, scratch; L, cap, pop, group, Nd, n_cells, size, norm, fused,
    # trim_k, reuse, sorted_merge; reg; stream
    "goicp_inner_step": [_P] * 37 + [_I] * 12 + [ctypes.c_float, _P],
    # slots (47: search/inner.py::_run_specs), n_slots, ints (17), n_ints,
    # reg, stream
    "goicp_inner_run": [ctypes.POINTER(ctypes.c_ulonglong), _I,
                        ctypes.POINTER(_I), _I, ctypes.c_float, _P],
    # p, bytes, stream
    "goicp_zero_words": [_P, _L, _P],
    # slots, n_slots, ints, n_ints, rows, n, stream
    "goicp_harvest": [ctypes.POINTER(ctypes.c_ulonglong), _I,
                      ctypes.POINTER(_I), _I, ctypes.POINTER(_I), _I, _P],
    # slots, n_slots, ints, n_ints, root, rows, out_rows (NULL: 0..n-1), n,
    # stream
    "goicp_advance": [ctypes.POINTER(ctypes.c_ulonglong), _I,
                      ctypes.POINTER(_I), _I, ctypes.POINTER(ctypes.c_float),
                      ctypes.POINTER(_I), ctypes.POINTER(_I), _I, _P],
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


def _compile(compiler: str, flags: tuple, sources: list, stem: str,
             log_flags: tuple = ()):
    """Compile sources into BUILD_DIR/<stem>_<hash of flags and sources>.so
    unless it is there.  log_flags only add to the compiler's log (the
    same library, so not hashed).  Returns (path, compiler log): the log
    is kept beside the library (<name>.so.log) and read back when the
    library was already built; a library without its log is built again.
    Processes that build at once (the ranks of a multi-GPU run) take turns
    under a file lock, so one builds and the others load its library; the
    lock goes with its process."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    out = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return out, _compile_locked(compiler, flags + log_flags, sources,
                                    out)


def _run(cmds: list) -> str:
    """Run the commands at once, each in its own process; their output in
    order.  Raises with the first failure's command and output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed with "
                               f"code {p.returncode}:\n{' '.join(cmd)}\n"
                               f"{log}")
    return "".join(logs)


def _compile_locked(compiler: str, flags: tuple, sources: list,
                    out: pathlib.Path) -> str:
    """Compile every source into an object file, all at once (one compiler
    process each), then link them into `out`; the log beside it."""
    log_path = out.with_name(f"{out.name}.log")
    if out.exists() and log_path.exists():
        return log_path.read_text()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    units = [p for p in sources if p.suffix in (".cu", ".cpp")]
    objs = [tmp.with_name(f"{tmp.name}.{p.name}.o") for p in units]
    obj_flags = [f for f in flags if f != "-shared"]
    try:
        log = _run([[compiler, *obj_flags, "-c", str(p), "-o", str(o)]
                    for p, o in zip(units, objs)])
        log += _run([[compiler, *flags, "-o", str(tmp), *map(str, objs)]])
        log_path.write_text(log)
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return log


def host_library() -> ctypes.CDLL:
    """The host C++ runtime (native/*.cpp: the outer search's batched heap,
    the .mol2 and float-table parsers), built with the host's C++ compiler
    at first use.  Its bindings are declared in native/__init__.py."""
    global _host_lib
    if _host_lib is None:
        cxx = shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: "
                               "the native runtime is built at first use")
        out, _ = _compile(cxx, HOST_FLAGS, sorted(HOST_SRC.glob("*.cpp")),
                          "libgoicp_host")
        _host_lib = ctypes.CDLL(str(out))
    return _host_lib


def _declare(lib: ctypes.CDLL, every: bool = True) -> ctypes.CDLL:
    """Declare the C functions of _SIGNATURES in lib (every: all of them
    must be there; else those it holds)."""
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name) if every else getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def variant(sources: tuple, defines: tuple, csrc: pathlib.Path = CSRC,
            stem: str = "libgoicp_variant",
            logs: dict | None = None) -> ctypes.CDLL:
    """A library of some of the kernel sources (names in csrc, every header
    of csrc beside them) built with extra `-D` defines, for a measurement
    that compiles stop points into a kernel (bench/inner_stops.py,
    bench/icp_stops.py).  Named by the hash of its sources and flags like
    library()'s, so a variant is built once; builds of distinct stems may
    run at once.  logs: a dict that gets logs[stem], the build's log with
    ptxas's report."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    out, log = _compile(_nvcc(), flags, [csrc / n for n in sources]
                        + sorted(csrc.glob("*.cuh")), stem, PTXAS_LOG)
    if logs is not None:
        logs[stem] = log
    return _declare(ctypes.CDLL(str(out)), every=False)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  Its build's log,
    with ptxas's registers, stack frame and spills per kernel, is in
    build_info["log"]."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    out, log = _compile(_nvcc(), NVCC_FLAGS, sorted(CSRC.glob("*.cu"))
                        + sorted(CSRC.glob("*.cuh")), "libgoicp_kernels",
                        PTXAS_LOG)
    lib = _declare(ctypes.CDLL(str(out)))
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      log=log)
    _lib = lib
    return lib
