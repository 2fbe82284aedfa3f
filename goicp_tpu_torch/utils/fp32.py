"""One float32 order for every sum and product on the registration path,
the same on the card and on the CPU.

Float addition is not associative, so a sum depends on the order its terms
are added in.  torch.sum, matmul, einsum and linalg.norm leave that order
to the device's library (cuBLAS, the CPU's BLAS and its thread count),
and a library may fuse a*b + c into one FMA on one device and not on the
other; torch.cos and torch.sin come from CUDA's libm on the card and from
SLEEF or glibc on the CPU.  Then the same registration prunes differently
on the two devices.  So every non-integer reduction and product on the
registration path goes through this module, and a new one must.  Integer
counts (exact below 2**24 in any order), sorts, argmin's first index,
IEEE division and grid/edt.py::exact_sqrt are the same on both devices
already.

ordered_sum(x, dim, lanes=32) adds in this order, exactly:

  1. pad the dimension with +0.0 to a multiple of `lanes` and view it as
     (J, lanes);
  2. lane t (0 <= t < lanes) starts from +0.0 and adds x[t], x[t + lanes],
     ..., x[t + (J-1) lanes], in that order;
  3. then, for off = lanes/2, ..., 2, 1, every lane t takes
     acc[t] + acc[t ^ off];
  4. the result is lane 0's.

Every + is one float32 addition rounded to nearest: the plain version is
a loop of elementwise adds (never addcmul or an alpha= form, which may
fuse into an FMA).  Since +0.0 + (-0.0) is +0.0, a sum is never -0.0, and
the padding changes nothing else.  lanes=32 is the bound kernels' order
(csrc/geom_bounds.cu: each of a warp's 32 lanes adds its points t, t+32,
... and common.cuh's warp_sum, an xor butterfly, combines them), so K1/K3
and their plain twins (bounds/cuda_eval.py::reduce_bounds) are one
function.  lanes=1 is the sequential order ((0 + x0) + x1) + ..., which
XLA:CPU takes for a reduce run op by op: the Kabsch step of the ICP
(icp/icp.py::kabsch_from_H) keeps it, so that it stays bit-equal to the
JAX package's run op by op.  On a CUDA tensor the sum is one launch of
csrc/ordered_sum.cu (a warp per row), counted in `ordered_sum.launches`;
on a CPU tensor it is ordered_sum_plain.  There is no other fallback.

Built on it, each product rounded once before the sum:

  dot3(a, b)     ordered_sum(a * b, -1) over a last axis of 3, which is
                 (a0*b0 + a2*b2) + a1*b1;
  rotate(R, p)   (..., 3, 3) x (N, 3) -> (..., N, 3), R p for every point
                 (the einsum "lij,nj->lni");
  matmul3(A, B)  3x3 products, matvec3(A, v) 3x3 times a vector;
  norm3(v)       exact_sqrt(dot_fma(v, v)), jnp.linalg.norm's order (see
                 dot_fma), so that the point norms of the preparation
                 stay bit-equal to the JAX package's;
  cross3(a, b)   (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0), each
                 product and difference rounded once (torch.linalg.cross
                 fuses one of its products into an FMA on the card);
  sq_dist3(p, q) the squared distance matrix (|p|^2 - 2 p.q) + |q|^2 of
                 points p (..., N, 3) and q (M, 3), each dot a dot3;
  det3(M)        dot3(M0, cross3(M1, M2)) in the sequential order.

dot_fma(a, b) is the one other order, the one XLA:CPU gives a dot (even
run op by op) and the sum of squares of jnp.linalg.norm: a chain of FMAs,
acc = a0*b0, then acc = fma(a_k, b_k, acc) for k = 1, 2, ...  The FMA is
taken in float64 (the product of two float32 is exact there; the sum
rounds once to float64, then once to float32), which equals a float32
FMA except where the float64 sum lies on a float32 rounding midpoint,
about 2**-29 of the calls; the same on both devices.  The Kabsch's last
product R = V D U^T (the JAX package's einsum) and norm3 take it.

sq_dist3, det3, cross3 and dot_fma are one launch each of
csrc/fp32_products.cu on CUDA tensors (their torch forms take 3 to 11),
so that the ICP keeps the launch count of the library calls they
replace; on CPU tensors they are their elementwise torch forms
(`*_plain`), the same bits.  Each
kernel counts its launches in `<function>.launches`.

cos32 and sin32 evaluate in float64 and round once to float32, the idiom
of exact_sqrt.  Neither device's float64 cos or sin is correctly rounded,
but both are within an ulp of float64, so the float32 results differ only
where the float64 value lies within a few float64 ulps of a float32
rounding midpoint (a double rounding): about 2**-28 of the calls.
"""

from __future__ import annotations

import ctypes

import torch

from goicp_tpu_torch.grid.edt import exact_sqrt

LANES = (1, 32)     # the two orders in use: the warp order and the sequential
_DIMS = 4           # leading dims the cross3 and dot_fma kernels take


def _check(x: torch.Tensor, lanes: int):
    _check_f32(x)
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}, got {lanes}")


def _check_f32(*xs: torch.Tensor):
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"the fixed-order kernels take float32, got "
                            f"{x.dtype}")


def _on_cpu(*xs: torch.Tensor) -> bool:
    """True for CPU tensors (the plain versions); False for CUDA ones (the
    kernels); any other device, or a mix, raises."""
    kinds = {x.device.type for x in xs}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"no fixed-order kernel for devices {sorted(kinds)}")


def _ptr(x: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device pointer for a kernel, NULL for None."""
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _launch(symbol: str, what: str, *args):
    """Call the kernel library's `symbol`; raise on a CUDA error."""
    from goicp_tpu_torch._build import library
    err = getattr(library(), symbol)(*args)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def ordered_sum_plain(x: torch.Tensor, dim: int = -1,
                      lanes: int = 32) -> torch.Tensor:
    """The order of the module docstring in elementwise torch adds.  Rows
    shorter than `lanes` use the next power of two of their length as the
    lane count: the lanes above it hold +0.0, so the butterfly's steps
    across them add +0.0 to values that are never -0.0, which changes no
    bit."""
    _check(x, lanes)
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    while lanes > 1 and lanes // 2 >= n:
        lanes //= 2
    J = max(1, -(-n // lanes))
    if J * lanes != n:
        x = torch.nn.functional.pad(x, (0, J * lanes - n))
    xr = x.reshape(x.shape[:-1] + (J, lanes))
    acc = xr[..., 0, :] + 0.0
    for j in range(1, J):
        acc = acc + xr[..., j, :]
    off = lanes // 2
    while off:
        acc = acc[..., :off] + acc[..., off:2 * off]
        off //= 2
    return acc[..., 0]


def ordered_sum(x: torch.Tensor, dim: int = -1,
                lanes: int = 32) -> torch.Tensor:
    """Sum over `dim` in the module docstring's order: one launch of
    csrc/ordered_sum.cu on a CUDA tensor (made contiguous first),
    ordered_sum_plain on a CPU one."""
    if _on_cpu(x):
        return ordered_sum_plain(x, dim, lanes)
    _check(x, lanes)
    x = x.contiguous()
    dim = dim % x.dim()
    shape = tuple(x.shape)
    inner = 1
    for s in shape[dim + 1:]:
        inner *= s
    out = torch.empty(shape[:dim] + shape[dim + 1:], dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    _launch("goicp_ordered_sum", "ordered_sum", _ptr(x), _ptr(out),
            out.numel(), shape[dim], inner, lanes, _stream(x))
    ordered_sum.launches += 1
    return out


ordered_sum.launches = 0


def dot3(a: torch.Tensor, b: torch.Tensor, lanes: int = 32) -> torch.Tensor:
    """Dot products over the last axis (of 3), broadcasting a and b."""
    return ordered_sum(a * b, -1, lanes)


def rotate(R: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3), pts (N, 3) -> (..., N, 3): every point rotated by
    every R."""
    return dot3(R[..., None, :, :], pts[:, None, :])


def matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3)."""
    return dot3(A[..., :, None, :], B.transpose(-1, -2)[..., None, :, :])


def matvec3(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return dot3(A, v[..., None, :])


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norms over the last axis (of 3), the squares summed as
    dot_fma sums them."""
    return exact_sqrt(dot_fma(v, v))


def dot_fma_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dot_fma in elementwise torch ops."""
    a, b = torch.broadcast_tensors(a, b)
    acc = a[..., 0] * b[..., 0]
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    for k in range(1, a.shape[-1]):
        acc = (a64[..., k] * b64[..., k]
               + acc.to(torch.float64)).to(torch.float32)
    return acc


def broadcast_meta(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The cross3 and dot_fma kernels' view of broadcast operands a and b
    of one shape: the leading dims' sizes, a's and b's strides over them
    (0 where one broadcasts; the leading dims padded to _DIMS with size
    1), the two strides of the last axis and its length."""
    lead = a.shape[:-1]
    if len(lead) > _DIMS:
        raise ValueError(f"the kernels take at most {_DIMS} leading dims, "
                         f"got shape {tuple(a.shape)}")
    pad = _DIMS - len(lead)
    return ((1,) * pad + tuple(lead) + (0,) * pad + a.stride()[:-1]
            + (0,) * pad + b.stride()[:-1]
            + (a.stride(-1), b.stride(-1), a.shape[-1]))


def dot_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot products over the last axis, broadcasting a and b, as a chain of
    FMAs from the first term (the module docstring's dot_fma): one launch
    of csrc/fp32_products.cu on CUDA tensors (at most 4 leading dims),
    dot_fma_plain on CPU ones."""
    if _on_cpu(a, b):
        return dot_fma_plain(a, b)
    _check_f32(a, b)
    a, b = torch.broadcast_tensors(a, b)
    meta = broadcast_meta(a, b)
    out = torch.empty(a.shape[:-1], dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    _launch("goicp_dot_fma", "dot_fma", _ptr(a), _ptr(b), _ptr(out),
            (ctypes.c_longlong * len(meta))(*meta), _stream(a))
    dot_fma.launches += 1
    return out


dot_fma.launches = 0


def sq_dist3_plain(points: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """sq_dist3 in elementwise torch ops."""
    cross = dot3(points[..., :, None, :], model)
    return (dot3(points, points)[..., None] - 2.0 * cross
            + dot3(model, model))


def sq_dist3(points: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """points (..., N, 3) x model (M, 3) -> (..., N, M) squared distances
    in the JAX package's algebra, (|p|^2 - 2 p.q) + |q|^2, every dot a
    dot3: one launch of csrc/fp32_products.cu on CUDA tensors (no (..., N,
    M, 3) products in memory), sq_dist3_plain on CPU ones."""
    if _on_cpu(points, model):
        return sq_dist3_plain(points, model)
    _check_f32(points, model)
    p, q = points.contiguous(), model.contiguous()
    out = torch.empty(p.shape[:-1] + (q.shape[0],), dtype=torch.float32,
                      device=p.device)
    if out.numel() == 0:
        return out
    _launch("goicp_sq_dist3", "sq_dist3", _ptr(p), _ptr(q), _ptr(out),
            p.numel() // 3, q.shape[0], _stream(p))
    sq_dist3.launches += 1
    return out


sq_dist3.launches = 0


def det3_plain(M: torch.Tensor) -> torch.Tensor:
    """det3 in elementwise torch ops."""
    return dot3(M[..., 0, :], cross3(M[..., 1, :], M[..., 2, :]), 1)


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinants of (..., 3, 3) matrices, row 0 dotted with the cross
    product of rows 1 and 2 in the sequential order (lanes=1): one launch
    of csrc/fp32_products.cu on a CUDA tensor, det3_plain on a CPU one."""
    if _on_cpu(M):
        return det3_plain(M)
    _check_f32(M)
    M = M.contiguous()
    out = torch.empty(M.shape[:-2], dtype=torch.float32, device=M.device)
    if out.numel() == 0:
        return out
    _launch("goicp_det3", "det3", _ptr(M), _ptr(out), out.numel(),
            _stream(M))
    det3.launches += 1
    return out


det3.launches = 0


def cross3_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cross3 in elementwise torch ops: the antisymmetric part of the
    outer product a b^T, read off."""
    outer = a[..., :, None] * b[..., None, :]
    w = outer - outer.transpose(-1, -2)
    return torch.stack([w[..., 1, 2], w[..., 2, 0], w[..., 0, 1]], dim=-1)


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross products over the last axis (of 3), broadcasting a and b, each
    entry a1*b2 - a2*b1 (and its rotations) with both products and the
    difference rounded once: one launch of csrc/fp32_products.cu on CUDA
    tensors (at most 4 leading dims), cross3_plain on CPU ones."""
    if _on_cpu(a, b):
        return cross3_plain(a, b)
    _check_f32(a, b)
    a, b = torch.broadcast_tensors(a, b)
    meta = broadcast_meta(a, b)
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    _launch("goicp_cross3", "cross3", _ptr(a), _ptr(b), _ptr(out),
            (ctypes.c_longlong * len(meta))(*meta), _stream(a))
    cross3.launches += 1
    return out


cross3.launches = 0


def cos32(x: torch.Tensor) -> torch.Tensor:
    """cos in float64, rounded once to float32."""
    return torch.cos(x.to(torch.float64)).to(torch.float32)


def sin32(x: torch.Tensor) -> torch.Tensor:
    """sin in float64, rounded once to float32."""
    return torch.sin(x.to(torch.float64)).to(torch.float32)
