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
  rotate(R, p, t=None)  (..., 3, 3) x (N, 3) -> (..., N, 3), R p for
                 every point (the einsum "lij,nj->lni"), each coordinate a
                 dot3, then + t (..., 3) where t is given;
  matmul3(A, B)  3x3 products, matvec3(A, v) 3x3 times a vector;
  cross3(a, b)   (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0), each
                 product and difference rounded once (torch.linalg.cross
                 fuses one of its products into an FMA on the card);
  sq_dist3(p, q) the squared distance matrix (|p|^2 - 2 p.q) + |q|^2 of
                 points p (..., N, 3) and q (M, 3), each dot a dot3;
  det3(M)        dot3(M0, cross3(M1, M2)) in the sequential order.

dot_fma(a, b) is the one other order, the one XLA:CPU gives a dot (even
run op by op) and the sum of squares of jnp.linalg.norm: a chain of
float32 FMAs, acc = a0*b0, then acc = fma(a_k, b_k, acc) for k = 1, 2,
..., each fma a*b + acc rounded once (__fmaf_rn on the card).  The plain
version computes the same value exactly: the float64 sum s = a*b + acc
(the product is exact there) and its error e by TwoSum; where e != 0 and
s's last bit is even, s steps one float64 ulp toward e (round to odd);
then one rounding to float32, which is correct since 53 >= 24 + 2.  The
Kabsch's last product R = V D U^T (the JAX package's einsum) takes it,
and so does

  norm3(v)       sqrt(dot_fma(v, v)) over a last axis of 3, the square
                 root correctly rounded (grid/edt.py::exact_sqrt on the
                 CPU), jnp.linalg.norm's order, so that the point norms of
                 the preparation stay bit-equal to the JAX package's.

sincos32(x) -> (sin x, cos x) of float32 angles, the same bits on both
devices (the devices' own float64 libms differ).  Every step below is one
float64 operation rounded once (__dmul_rn / __dadd_rn on the card, one
torch op on the CPU, never fused), and each result is rounded once to
float32:

  1. k = rint(x * 2/pi), then r = (x - k * P1) - k * P2, where P1 =
     0x1.921fb544p+0 holds the first 33 bits of pi/2 (so k * P1 and x -
     k * P1 are exact for |k| < 2^20) and P2 = 0x1.0b4611a626331p-34 the
     next 53 (fdlibm's pio2_1, pio2_1t); |r| <= pi/4 (+ an ulp);
  2. z = r * r; by Horner from the highest coefficient,
     ps = S1 + z (S2 + z (... + z S8)) with S_j = (-1)^j / (2j+1)!, and
     pc = C1 + z (C2 + z (... + z C8)) with C_j = (-1)^j / (2j)!, each
     coefficient 1/n! correctly rounded (_SIN_C, _COS_C; the same hex
     literals in csrc/fp32_order.cuh);
  3. sin r = r + (r * z) * ps (degree 17), cos r = 1 + z * pc (degree 16);
     the truncation error on |r| <= pi/4 is below 2^-53 relative;
  4. the quadrant q = k mod 4: sin x = (sin r, cos r, -sin r, -cos r)[q],
     cos x = (cos r, -sin r, -cos r, sin r)[q].

For finite |x| < 2^20 the float64 value is within a few float64 ulps of
sin x and cos x, so the float32 result is the correctly rounded one
except within a few float64 ulps of a float32 rounding midpoint (about
2^-27 of the angles).  rodrigues and the rotation uncertainty take it.

On CUDA tensors each of ordered_sum, rotate, norm3, sincos32, sq_dist3,
det3, cross3 and dot_fma is one launch (csrc/ordered_sum.cu: the sum and
rotate; csrc/fp32_products.cu: the others), counted in
`<function>.launches`; on CPU tensors each is its elementwise torch form
(`*_plain`), the same bits, and there is no other fallback.  Their work
is a few hundred bytes to a few hundred KB, so a launch's cost is the
host's: the library's C functions are looked up once (`kernels`),
pointers and the stream handle pass as plain ints, and a wrapper does its
checks and one C call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from goicp_tpu_torch.grid.edt import exact_sqrt

LANES = (1, 32)     # the two orders in use: the warp order and the sequential
_DIMS = 4           # leading dims the cross3 and dot_fma kernels take

# sincos32's constants (the module docstring), as in csrc/fp32_order.cuh
_TWO_OVER_PI = float.fromhex("0x1.45f306dc9c883p-1")
_PIO2_HI = float.fromhex("0x1.921fb544p+0")
_PIO2_LO = float.fromhex("0x1.0b4611a626331p-34")
_SIN_C = tuple(map(float.fromhex, (
    "-0x1.5555555555555p-3", "0x1.1111111111111p-7", "-0x1.a01a01a01a01ap-13",
    "0x1.71de3a556c734p-19", "-0x1.ae64567f544e4p-26", "0x1.6124613a86d09p-33",
    "-0x1.ae7f3e733b81fp-41", "0x1.952c77030ad4ap-49")))
_COS_C = tuple(map(float.fromhex, (
    "-0x1.0000000000000p-1", "0x1.5555555555555p-5", "-0x1.6c16c16c16c17p-10",
    "0x1.a01a01a01a01ap-16", "-0x1.27e4fb7789f5cp-22", "0x1.1eed8eff8d898p-29",
    "-0x1.93974a8c07c9dp-37", "0x1.ae7f3e733b81fp-45")))


def _check(x: torch.Tensor, lanes: int):
    _check_f32(x)
    _check_lanes(lanes)


def _check_lanes(lanes: int):
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}, got {lanes}")


def _check_f32(*xs: torch.Tensor):
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"the fixed-order kernels take float32, got "
                            f"{x.dtype}")


def _on_card(*xs: torch.Tensor) -> bool:
    """True for CUDA float32 tensors (the kernels take them), False for
    CPU tensors (the plain versions); another device, a mix, or on the
    card another type raises.  The kernels' case is one pass of two
    attribute reads a tensor."""
    for x in xs:
        if not x.is_cuda or x.dtype is not torch.float32:
            break
    else:
        return True
    if _on_cpu(*xs):
        return False
    _check_f32(*xs)     # CUDA tensors, one of another type: raises
    return True


def _on_cpu(*xs: torch.Tensor) -> bool:
    """True for CPU tensors (the plain versions); False for CUDA ones (the
    kernels); any other device, or a mix, raises."""
    kinds = {x.device.type for x in xs}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"no fixed-order kernel for devices {sorted(kinds)}")


class _Kernels:
    """The kernel library's C functions by name, each looked up once: the
    first read of a name builds or loads the library (_build.library) and
    keeps the function as an attribute, which later reads find
    directly."""

    def __getattr__(self, name: str):
        from goicp_tpu_torch._build import library
        fn = getattr(library(), name)
        setattr(self, name, fn)
        return fn


kernels = _Kernels()


def _ptr(x: torch.Tensor | None) -> int | None:
    """A tensor's device pointer for a kernel, None (NULL) for None."""
    return None if x is None else x.data_ptr()


def _stream(x: torch.Tensor) -> int:
    """The handle of the current CUDA stream on x's card, read without the
    torch.cuda.Stream object that torch.cuda.current_stream() builds."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _launch(err: int, what: str):
    """Raise on a kernel call's CUDA error (the C function returns
    cudaGetLastError() after its launch)."""
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
    if not _on_card(x):
        return ordered_sum_plain(x, dim, lanes)
    _check_lanes(lanes)
    x = x.contiguous()
    shape = list(x.shape)
    n = shape.pop(dim)
    out = x.new_empty(shape)
    rows = out.numel()
    if rows == 0:
        return out
    # a contiguous tensor's stride over a dim longer than 1 is the product
    # of the later dims; over a dim of 1 any row step is right
    _launch(kernels.goicp_ordered_sum(
        x.data_ptr(), out.data_ptr(), rows, n,
        x.stride(dim) if n > 1 else 1, lanes, _stream(x)), "ordered_sum")
    ordered_sum.launches += 1
    return out


ordered_sum.launches = 0


def dot3(a: torch.Tensor, b: torch.Tensor, lanes: int = 32) -> torch.Tensor:
    """Dot products over the last axis (of 3), broadcasting a and b."""
    return ordered_sum(a * b, -1, lanes)


def rotate_plain(R: torch.Tensor, pts: torch.Tensor,
                 t: torch.Tensor | None = None) -> torch.Tensor:
    """rotate in elementwise torch ops: the broadcast products, their sums
    in the warp order (ordered_sum_plain, which launches no kernel on
    any device), then + t."""
    out = ordered_sum_plain(R[..., None, :, :] * pts[:, None, :])
    return out if t is None else out + t[..., None, :]


def rotate(R: torch.Tensor, pts: torch.Tensor,
           t: torch.Tensor | None = None) -> torch.Tensor:
    """R (..., 3, 3), pts (N, 3) -> (..., N, 3): every point rotated by
    every R, each coordinate a dot3, then + t[..., None, :] for t (..., 3)
    (broadcast against R's leading dims) where t is given: one launch of
    csrc/ordered_sum.cu on CUDA tensors, rotate_plain on CPU ones."""
    if not (_on_card(R, pts) if t is None else _on_card(R, pts, t)):
        return rotate_plain(R, pts, t)
    if R.dim() < 2 or R.shape[-1] != 3 or R.shape[-2] != 3 \
            or pts.dim() != 2 or pts.shape[1] != 3 \
            or (t is not None and (t.dim() < 1 or t.shape[-1] != 3)):
        raise ValueError(f"rotate takes R (..., 3, 3), pts (N, 3) and t "
                         f"(..., 3), got {tuple(R.shape)}, "
                         f"{tuple(pts.shape)}, "
                         f"{None if t is None else tuple(t.shape)}")
    lead = R.shape[:-2]
    if t is not None and t.shape[:-1] != lead:
        lead = torch.broadcast_shapes(lead, t.shape[:-1])
        R, t = R.expand(lead + (3, 3)), t.expand(lead + (3,))
    R, pts = R.contiguous(), pts.contiguous()
    if t is not None:
        t = t.contiguous()
    n = pts.shape[0]
    out = R.new_empty((*lead, n, 3))
    if out.numel() == 0:
        return out
    _launch(kernels.goicp_rotate(
        R.data_ptr(), pts.data_ptr(), _ptr(t), out.data_ptr(),
        R.numel() // 9, n, _stream(R)), "rotate")
    rotate.launches += 1
    return out


rotate.launches = 0


def matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3)."""
    return dot3(A[..., :, None, :], B.transpose(-1, -2)[..., None, :, :])


def matvec3(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return dot3(A, v[..., None, :])


def _fma32(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The float32 nearest to p + c, for float64 p and c (p a product of
    two float32, exact): the float64 sum rounded to odd by TwoSum and
    nextafter, then rounded once to float32 (the module docstring)."""
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    step = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    s = torch.where(step, torch.nextafter(
        s, s.new_full((), math.inf).copysign(e)), s)
    return s.to(torch.float32)


def dot_fma_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dot_fma in elementwise torch ops, each float32 FMA exact as _fma32
    takes it."""
    a, b = torch.broadcast_tensors(a, b)
    acc = a[..., 0] * b[..., 0]
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    for k in range(1, a.shape[-1]):
        acc = _fma32(a64[..., k] * b64[..., k], acc.to(torch.float64))
    return acc


def _broadcast_strides(shape: tuple, own: tuple, strides: tuple) -> tuple:
    """An operand's strides over the broadcast shape: 0 over the dims it
    lacks or broadcasts from 1."""
    pad = len(shape) - len(own)
    return (0,) * pad + tuple(0 if n == 1 and m != 1 else s for n, s, m in
                              zip(own, strides, shape[pad:]))


@functools.lru_cache(maxsize=256)
def _broadcast_view(shape_a: tuple, stride_a: tuple, shape_b: tuple,
                    stride_b: tuple):
    """(the broadcast shape, the cross3 and dot_fma kernels' description of
    it as a c_longlong[15]) for operands of these shapes and strides: the
    leading dims' sizes, a's and b's strides over them (0 where one
    broadcasts; the leading dims padded to _DIMS with size 1), the two
    strides of the last axis and its length.  Kept per layout, so that a
    call finds it with one lookup; the kernels only read it (they copy it
    at their launch), so every caller may share it."""
    shape = tuple(torch.broadcast_shapes(shape_a, shape_b))
    sa = _broadcast_strides(shape, shape_a, stride_a)
    sb = _broadcast_strides(shape, shape_b, stride_b)
    lead = shape[:-1]
    if len(lead) > _DIMS:
        raise ValueError(f"the kernels take at most {_DIMS} leading dims, "
                         f"got shape {shape}")
    pad = _DIMS - len(lead)
    meta = ((1,) * pad + lead + (0,) * pad + sa[:-1] + (0,) * pad + sb[:-1]
            + (sa[-1], sb[-1], shape[-1]))
    return shape, (ctypes.c_longlong * len(meta))(*meta)


def broadcast_meta(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """_broadcast_view's description of operands a and b, as a tuple."""
    return tuple(_broadcast_view(a.shape, a.stride(), b.shape,
                                 b.stride())[1])


def dot_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot products over the last axis, broadcasting a and b, as a chain of
    float32 FMAs from the first term (the module docstring's dot_fma): one
    launch of csrc/fp32_products.cu on CUDA tensors (at most 4 leading
    dims), dot_fma_plain on CPU ones."""
    if not _on_card(a, b):
        return dot_fma_plain(a, b)
    shape, meta = _broadcast_view(a.shape, a.stride(), b.shape, b.stride())
    out = a.new_empty(shape[:-1])
    if out.numel() == 0:
        return out
    _launch(kernels.goicp_dot_fma(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  meta, _stream(a)), "dot_fma")
    dot_fma.launches += 1
    return out


dot_fma.launches = 0


def norm3_plain(v: torch.Tensor) -> torch.Tensor:
    """norm3 in elementwise torch ops."""
    return exact_sqrt(dot_fma_plain(v, v))


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norms over the last axis (of 3), the squares summed as
    dot_fma sums them and the square root correctly rounded: one launch of
    csrc/fp32_products.cu on a CUDA tensor, norm3_plain on a CPU one."""
    if not _on_card(v):
        return norm3_plain(v)
    if v.dim() == 0 or v.shape[-1] != 3:
        raise ValueError(f"norm3 takes (..., 3), got {tuple(v.shape)}")
    v = v.contiguous()
    out = v.new_empty(v.shape[:-1])
    rows = out.numel()
    if rows == 0:
        return out
    _launch(kernels.goicp_norm3(v.data_ptr(), out.data_ptr(), rows,
                                _stream(v)), "norm3")
    norm3.launches += 1
    return out


norm3.launches = 0


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
    if not _on_card(points, model):
        return sq_dist3_plain(points, model)
    p, q = points.contiguous(), model.contiguous()
    out = p.new_empty(p.shape[:-1] + (q.shape[0],))
    if out.numel() == 0:
        return out
    _launch(kernels.goicp_sq_dist3(p.data_ptr(), q.data_ptr(),
                                   out.data_ptr(), p.numel() // 3,
                                   q.shape[0], _stream(p)), "sq_dist3")
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
    if not _on_card(M):
        return det3_plain(M)
    M = M.contiguous()
    out = M.new_empty(M.shape[:-2])
    if out.numel() == 0:
        return out
    _launch(kernels.goicp_det3(M.data_ptr(), out.data_ptr(), out.numel(),
                               _stream(M)), "det3")
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
    if not _on_card(a, b):
        return cross3_plain(a, b)
    shape, meta = _broadcast_view(a.shape, a.stride(), b.shape, b.stride())
    out = a.new_empty(shape)
    if out.numel() == 0:
        return out
    _launch(kernels.goicp_cross3(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 meta, _stream(a)), "cross3")
    cross3.launches += 1
    return out


cross3.launches = 0


def _horner(z: torch.Tensor, coeffs: tuple) -> torch.Tensor:
    """c1 + z (c2 + z (... + z c8)) from the highest coefficient, one
    float64 multiply and one add a step."""
    p = coeffs[-1] * z
    for c in reversed(coeffs[1:-1]):
        p = (p + c) * z
    return p + coeffs[0]


def sincos32_plain(x: torch.Tensor):
    """sincos32 in elementwise float64 torch ops, the module docstring's
    steps in order: (sin x, cos x) in float32."""
    t = x.to(torch.float64)
    k = torch.round(t * _TWO_OVER_PI)
    r = (t - k * _PIO2_HI) - k * _PIO2_LO
    z = r * r
    sr = r + (r * z) * _horner(z, _SIN_C)
    cr = 1.0 + z * _horner(z, _COS_C)
    q = k.to(torch.int64) & 3
    odd = (q & 1) == 1
    sv, cv = torch.where(odd, cr, sr), torch.where(odd, sr, cr)
    return (torch.where((q & 2) == 2, -sv, sv).to(torch.float32),
            torch.where((q == 1) | (q == 2), -cv, cv).to(torch.float32))


def sincos32(x: torch.Tensor):
    """(sin x, cos x) of float32 angles, the module docstring's float64
    evaluation rounded once to float32, the same bits on every device:
    one launch of csrc/fp32_products.cu for both on a CUDA tensor,
    sincos32_plain on a CPU one."""
    if not _on_card(x):
        return sincos32_plain(x)
    x = x.contiguous()
    s, c = torch.empty_like(x), torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return s, c
    _launch(kernels.goicp_sincos32(x.data_ptr(), s.data_ptr(), c.data_ptr(),
                                   n, _stream(x)), "sincos32")
    sincos32.launches += 1
    return s, c


sincos32.launches = 0
