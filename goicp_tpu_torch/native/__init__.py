"""ctypes bindings for the host C++ runtime (frontier.cpp, parsers.cpp).

Port of goicp_tpu/native/__init__.py.  The library is built at first use by
goicp_tpu_torch/_build.py::host_library; a failed build raises, and no
binding falls back to Python (search/outer.py::PyFrontier stays as the
tests' oracle for the heap).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_NAME_BYTES = 8          # parse_mol2_atoms: NUL-padded atom names per row


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from goicp_tpu_torch._build import host_library
    lib = host_library()
    lib.gf_new.restype = ctypes.c_void_p
    lib.gf_new.argtypes = [ctypes.c_uint64]
    lib.gf_free.restype = None
    lib.gf_free.argtypes = [ctypes.c_void_p]
    lib.gf_size.restype = ctypes.c_uint64
    lib.gf_size.argtypes = [ctypes.c_void_p]
    lib.gf_min_lb.restype = ctypes.c_float
    lib.gf_min_lb.argtypes = [ctypes.c_void_p]
    lib.gf_min_dropped_lb.restype = ctypes.c_double
    lib.gf_min_dropped_lb.argtypes = [ctypes.c_void_p]
    lib.gf_push_batch.restype = None
    lib.gf_push_batch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  _F32P, _F32P, _F32P, _F32P, _F32P, _I32P,
                                  _F32P]
    lib.gf_pop_batch.restype = ctypes.c_int64
    lib.gf_pop_batch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_float, _F32P, _F32P, _F32P, _F32P,
                                 _F32P, _I32P, _F32P]
    lib.gf_clear.restype = None
    lib.gf_clear.argtypes = [ctypes.c_void_p]
    lib.parse_mol2_atoms.restype = ctypes.c_int64
    lib.parse_mol2_atoms.argtypes = [ctypes.c_char_p, ctypes.c_int64, _F64P,
                                     ctypes.c_char_p]
    lib.parse_float_table.restype = ctypes.c_int64
    lib.parse_float_table.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      _F64P]
    return lib


class NativeFrontier:
    """Batched min-heap over rotation cubes, keyed (lb, push order); the
    API of search/outer.py::PyFrontier.  capacity 0 means unbounded."""

    def __init__(self, capacity: int = 0):
        self._lib = _lib()
        self._h = self._lib.gf_new(capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gf_free(self._h)
            self._h = None

    def __len__(self):
        return int(self._lib.gf_size(self._h))

    @property
    def min_lb(self) -> float:
        return float(self._lib.gf_min_lb(self._h))

    @property
    def min_dropped_lb(self) -> float:
        return float(self._lib.gf_min_dropped_lb(self._h))

    def push(self, lb, a, b, c, w, level, ub):
        cols = [np.ascontiguousarray(x, np.float32) for x in (lb, a, b, c, w)]
        level = np.ascontiguousarray(level, np.int32)
        ub = np.ascontiguousarray(ub, np.float32)
        n = len(cols[0])
        if any(len(x) != n for x in (*cols, level, ub)):
            raise ValueError("frontier push: columns of different lengths")
        self._lib.gf_push_batch(self._h, n, *cols, level, ub)

    def pop(self, max_n: int, opt_err: float):
        """Up to max_n lowest-lb nodes with lb < opt_err (float32), as
        (lb, a, b, c, w, level, ub) arrays; stale nodes are discarded."""
        out = [np.empty(max_n, np.float32) for _ in range(6)]
        level = np.empty(max_n, np.int32)
        k = int(self._lib.gf_pop_batch(self._h, max_n, np.float32(opt_err),
                                       *out[:5], level, out[5]))
        return (out[0][:k], out[1][:k], out[2][:k], out[3][:k], out[4][:k],
                level[:k], out[5][:k])

    def clear(self):
        self._lib.gf_clear(self._h)


def parse_mol2_atoms(path: str, max_n: int = 1 << 20):
    """The @<TRIPOS>ATOM block of a .mol2 file -> (coords (N,3) f64, atom
    names list[str], each cut to 7 characters)."""
    coords = np.empty((max_n, 3), np.float64)
    names = ctypes.create_string_buffer(max_n * _NAME_BYTES)
    n = int(_lib().parse_mol2_atoms(path.encode(), max_n, coords, names))
    if n < 0:
        raise ValueError(f"{path}: unreadable, or no @<TRIPOS>ATOM block")
    raw = names.raw[: n * _NAME_BYTES]
    return coords[:n].copy(), [
        raw[i * _NAME_BYTES:(i + 1) * _NAME_BYTES].split(b"\0", 1)[0]
        .decode() for i in range(n)]


def parse_float_table(path: str, max_vals: int) -> np.ndarray:
    """Every whitespace-separated float of a file, up to max_vals (f64)."""
    out = np.empty(max_vals, np.float64)
    n = int(_lib().parse_float_table(path.encode(), max_vals, out))
    if n < 0:
        raise OSError(f"{path}: cannot be read")
    return out[:n].copy()
