"""The fixed-order functions that are one launch each on the card
(goicp_tpu_torch/utils/fp32.py: rotate, norm3, sincos32, and dot_fma's
float32 FMA), held on the CPU to what they replace and to exact
arithmetic:

  * rotate_plain, with and without t, equals the dot3 composition it
    replaces bit for bit, and the JAX package's einsum "lij,nj->lni" (+ t)
    on XLA:CPU at the ICP tests' atol 1e-5;
  * dot_fma_plain equals the correctly rounded float32 FMA chain computed
    with fractions.Fraction, on random inputs and on built inputs where
    the float64 route (a*b + acc in float64, then float32) rounds twice
    and is wrong; on those, jnp.dot on XLA:CPU equals the port (XLA:CPU
    takes a true float32 FMA), and jnp.linalg.norm equals norm3 on built
    vectors whose norm the double rounding moves;
  * norm3_plain equals jnp.linalg.norm bit for bit;
  * sincos32_plain equals numpy's float64 sin and cos rounded once to
    float32 on 2^17 angles in [0, pi sqrt(3)] (rodrigues' range), and its
    constants equal csrc/fp32_order.cuh's hex literals.

Tests marked `cuda` hold each kernel to its plain version on the card;
JAX is imported only by the tests that compare with it, so that on a
machine with a card and no JAX these run alone:

    python -m pytest --noconftest tests/test_torch_fp32_fused.py -m cuda"""

import math
import pathlib
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from goicp_tpu_torch.utils import fp32

torch.set_num_threads(1)

F32 = np.float32
TOL = dict(rtol=0, atol=1e-5)    # tests/test_torch_icp.py's
ORDER_CUH = (pathlib.Path(fp32.__file__).resolve().parents[1] / "csrc"
             / "fp32_order.cuh")


def bits(x):
    return np.asarray(x, F32).view(np.int32)


def f32_nearest(x: Fraction) -> F32:
    """The float32 nearest to the rational x, ties to the even mantissa
    (no overflow; x != 0)."""
    f = F32(float(x))        # within an ulp of the answer
    cands = (np.nextafter(f, F32(-np.inf)), f, np.nextafter(f, F32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(bits(c)) & 1))


def exact_dot_fma(a, b) -> F32:
    """acc = a0 b0 rounded, then acc = a_k b_k + acc rounded once, k >= 1."""
    acc = F32(a[0] * b[0])
    for ak, bk in zip(a[1:], b[1:]):
        acc = f32_nearest(Fraction(float(ak)) * Fraction(float(bk))
                          + Fraction(float(acc)))
    return acc


def float64_route(a, b) -> F32:
    """The FMA chain taken in float64 and rounded to float32 each step
    (the port's dot_fma before it took a true FMA)."""
    acc = F32(a[0] * b[0])
    for ak, bk in zip(a[1:], b[1:]):
        acc = F32(np.float64(ak) * np.float64(bk) + np.float64(acc))
    return acc


def dot_cases(n, seed):
    """Two-term dots (c, a) . (1, b) whose FMA a b + c rounds twice in
    float64: c = +-2^ec (1 + k 2^-23) and a b = 2^(ec-24) (1 + eps) with
    |eps| < 2^-29, so a b + c lies within half a float64 ulp of the
    float32 midpoint c + 2^(ec-24), on the side away from its even
    neighbour: a = 2^x (1 + i 2^-23), b = 2^y (1 - (2i-1) 2^-24) give
    eps = 2^-36 (i = 2048) or -6145 2^-47 (i = 2049)."""
    rng = np.random.default_rng(seed)
    A, B = [], []
    for _ in range(n):
        ec, k = int(rng.integers(-20, 21)), int(rng.integers(0, 2**23 - 1))
        i = 2048 if k % 2 == 0 else 2049
        x = ec // 2 - 12
        c = math.ldexp(1 + k * 2.0**-23, ec)
        a = math.ldexp(1 + i * 2.0**-23, x)
        b = math.ldexp(1 - (2 * i - 1) * 2.0**-24, ec - 24 - x)
        sign = 1.0 if rng.random() < 0.5 else -1.0
        A.append([sign * c, sign * a])
        B.append([1.0, b])
    return np.array(A, F32), np.array(B, F32)


def norm_cases(n, seed):
    """3-vectors v whose norm the float64 route gets wrong: acc = v0^2
    rounded (tiny), then v1 v1 + acc rounds twice in float64 (v1 = M
    2^-23 with M^2 just below an odd multiple of 2^22, v0^2 = that gap
    + -2^-54), then v2 v2 + acc and the square root, kept where the
    wrong square moves the norm."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        for m in rng.integers(2**23, int(2**23 * 1.4142), size=50000):
            m = int(m)
            q = m * m // 2**22 + 1
            q += q % 2 == 0                 # the odd multiple above m^2
            gap = q * 2**22 - m * m         # in units of 2^-46
            if not 0 < gap < 2**16:
                continue
            units = 256 * gap + (1 if (q - 1) // 2 % 2 == 0 else -1)
            c = F32(math.ldexp(units, -54))
            f = F32(math.sqrt(float(c)))
            for v0 in (f, np.nextafter(f, F32(0)), np.nextafter(f, F32(1))):
                if F32(v0 * v0) != c:
                    continue
                v = np.array([v0, math.ldexp(m, -23),
                              rng.uniform(0.7, 1.0)], F32)
                v *= rng.choice([-1.0, 1.0], 3).astype(F32)
                wrong = np.sqrt(np.float64(float64_route(v, v)))
                right = np.sqrt(np.float64(exact_dot_fma(v, v)))
                if F32(wrong) != F32(right):
                    out.append(v)
                break
            if len(out) == n:
                break
    return np.stack(out)


def _rotate_inputs(seed, batch):
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(batch, 3, 3)).astype(F32)
    pts = rng.uniform(-0.8, 0.8, size=(192, 3)).astype(F32)
    t = rng.uniform(-0.1, 0.1, size=(batch, 3)).astype(F32)
    return R, pts, t


@pytest.mark.parametrize("shift", [False, True])
def test_rotate_plain_equals_the_dot3_composition_and_jax(shift):
    import jax.numpy as jnp
    R, pts, t = _rotate_inputs(5, 8 if not shift else 4)
    tR, tp, tt = map(torch.from_numpy, (R, pts, t))
    old = fp32.dot3(tR[..., None, :, :], tp[:, None, :])
    want = jnp.einsum("lij,nj->lni", R, pts)
    if shift:
        old = old + tt[..., None, :]
        want = want + t[:, None, :]
    got = fp32.rotate_plain(tR, tp, tt if shift else None)
    np.testing.assert_array_equal(bits(got.numpy()), bits(old.numpy()))
    np.testing.assert_array_equal(
        bits(fp32.rotate(tR, tp, tt if shift else None).numpy()),
        bits(got.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rotate_broadcasts_t_against_the_leading_dims():
    R, pts, t = _rotate_inputs(6, 4)
    tR, tp, tt = map(torch.from_numpy, (R, pts, t))
    got = fp32.rotate(tR[0], tp, tt)                  # one R, four t
    want = fp32.rotate(tR[:1].expand(4, 3, 3), tp) + tt[:, None, :]
    assert got.shape == (4, 192, 3)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want.numpy()))


@pytest.mark.parametrize("case", ["random", "double rounding"])
def test_dot_fma_plain_is_the_exact_float32_fma(case):
    if case == "random":
        rng = np.random.default_rng(8)
        A = (rng.normal(size=(400, 3))
             * 10.0 ** rng.uniform(-4, 4, size=(400, 3))).astype(F32)
        B = (rng.normal(size=(400, 3))
             * 10.0 ** rng.uniform(-4, 4, size=(400, 3))).astype(F32)
    else:
        A, B = dot_cases(300, seed=9)
        # the float64 route is wrong on every built case
        assert all(float64_route(a, b) != exact_dot_fma(a, b)
                   for a, b in zip(A, B))
    got = fp32.dot_fma_plain(torch.from_numpy(A), torch.from_numpy(B))
    want = np.array([exact_dot_fma(a, b) for a, b in zip(A, B)], F32)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    np.testing.assert_array_equal(
        bits(fp32.dot_fma(torch.from_numpy(A), torch.from_numpy(B)).numpy()),
        bits(want))


def test_port_equals_jax_dot_and_norm_where_float64_rounds_twice():
    import jax.numpy as jnp
    A, B = dot_cases(100, seed=10)
    got = fp32.dot_fma(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    jax_dot = np.array([np.asarray(jnp.dot(a, b)) for a, b in zip(A, B)],
                       F32)
    np.testing.assert_array_equal(bits(jax_dot), bits(got))
    V = norm_cases(40, seed=11)
    got = fp32.norm3(torch.from_numpy(V)).numpy()
    np.testing.assert_array_equal(
        bits(np.asarray(jnp.linalg.norm(V, axis=-1))), bits(got))
    want = np.array([F32(np.sqrt(np.float64(exact_dot_fma(v, v))))
                     for v in V], F32)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_norm3_plain_equals_jnp_linalg_norm():
    import jax.numpy as jnp
    rng = np.random.default_rng(12)
    v = (rng.normal(size=(20000, 3))
         * 10.0 ** rng.uniform(-3, 3, size=(20000, 1))).astype(F32)
    got = fp32.norm3_plain(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(
        bits(got), bits(np.asarray(jnp.linalg.norm(v, axis=-1))))
    np.testing.assert_array_equal(
        bits(fp32.norm3(torch.from_numpy(v)).numpy()), bits(got))


def test_sincos32_plain_equals_numpy_rounded_once():
    rng = np.random.default_rng(13)
    ang = np.concatenate([
        rng.uniform(0.0, math.pi * math.sqrt(3.0), 2**17),
        [0.0, math.pi / 4, math.pi / 2, math.pi, 1.5 * math.pi,
         math.pi * math.sqrt(3.0)]]).astype(F32)
    s, c = fp32.sincos32_plain(torch.from_numpy(ang))
    a64 = ang.astype(np.float64)
    for name, got, want in (("sin", s, np.sin(a64)), ("cos", c, np.cos(a64))):
        got = got.numpy()
        off = np.flatnonzero(bits(got) != bits(want.astype(F32)))
        # an exception may only lie within a few float64 ulps of a
        # float32 rounding midpoint (a double rounding); none is expected
        assert off.size == 0, (name, ang[off], got[off], want[off])
    ks, kc = fp32.sincos32(torch.from_numpy(ang))
    assert torch.equal(ks, s) and torch.equal(kc, c)


def test_sincos32_constants_equal_the_cuda_sources():
    src = ORDER_CUH.read_text()
    consts = dict(re.findall(r"\b(k\w+) = (-?0x[0-9a-f.]+p[-+]?\d+)", src))
    assert float.fromhex(consts["kTwoOverPi"]) == fp32._TWO_OVER_PI
    assert float.fromhex(consts["kPio2Hi"]) == fp32._PIO2_HI
    assert float.fromhex(consts["kPio2Lo"]) == fp32._PIO2_LO
    for j in range(8):
        assert float.fromhex(consts[f"kS{j + 1}"]) == fp32._SIN_C[j]
        assert float.fromhex(consts[f"kC{j + 1}"]) == fp32._COS_C[j]
        assert fp32._SIN_C[j] == (-1) ** (j + 1) / math.factorial(2 * j + 3)
        assert fp32._COS_C[j] == (-1) ** (j + 1) / math.factorial(2 * j + 2)


def _expanded_meta(a, b):
    """The kernels' broadcast description read off torch.broadcast_tensors'
    expanded views (how the wrappers built it before they kept one per
    layout)."""
    a, b = torch.broadcast_tensors(a, b)
    pad = 4 - (a.dim() - 1)
    return ((1,) * pad + tuple(a.shape[:-1]) + (0,) * pad + a.stride()[:-1]
            + (0,) * pad + b.stride()[:-1]
            + (a.stride(-1), b.stride(-1), a.shape[-1]))


@pytest.mark.parametrize("case", ["kabsch", "row", "same", "strided",
                                  "last axis"])
def test_broadcast_view_equals_the_expanded_tensors_description(case):
    A, B = torch.zeros(4, 3, 3), torch.zeros(4, 3, 3)
    a, b = {"kabsch": (A[..., :, None, :], B[..., None, :, :]),
            "row": (torch.zeros(2, 6, 3), B[0, 0]),
            "same": (A, B),
            "strided": (A[:, :, 0], B[:, 1]),
            "last axis": (torch.zeros(5, 1), torch.zeros(5, 3))}[case]
    shape, meta = fp32._broadcast_view(a.shape, a.stride(), b.shape,
                                       b.stride())
    assert shape == tuple(torch.broadcast_shapes(a.shape, b.shape))
    assert tuple(meta) == _expanded_meta(a, b)
    assert fp32._broadcast_view(a.shape, a.stride(), b.shape,
                                b.stride())[1] is meta     # kept


@pytest.mark.parametrize("fn", ["rotate", "norm3", "sincos32"])
def test_new_wrappers_refuse_other_devices(fn):
    meta = torch.zeros(4, 3, device="meta")
    args = {"rotate": (torch.zeros(4, 3, 3), meta),
            "norm3": (meta,), "sincos32": (meta[:, 0],)}[fn]
    with pytest.raises(ValueError):
        getattr(fp32, fn)(*args)


# ---------------------------------------------------------------------------
# on the card: each kernel vs its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_rotate_and_norm3_kernels_equal_their_plain_versions(card):
    R, pts, t = _rotate_inputs(14, 8)
    tR, tp, tt = map(torch.from_numpy, (R, pts, t))
    for shift in (None, tt):
        got = fp32.rotate(tR.to(card), tp.to(card),
                          None if shift is None else shift.to(card))
        np.testing.assert_array_equal(
            bits(got.cpu().numpy()),
            bits(fp32.rotate_plain(tR, tp, shift).numpy()))
    V = np.concatenate([norm_cases(20, seed=15), pts])
    got = fp32.norm3(torch.from_numpy(V).to(card)).cpu()
    np.testing.assert_array_equal(
        bits(got.numpy()), bits(fp32.norm3_plain(torch.from_numpy(V))))
    A, B = dot_cases(100, seed=16)
    got = fp32.dot_fma(torch.from_numpy(A).to(card),
                       torch.from_numpy(B).to(card)).cpu()
    np.testing.assert_array_equal(
        bits(got.numpy()),
        bits(fp32.dot_fma_plain(torch.from_numpy(A), torch.from_numpy(B))))


@pytest.mark.cuda
def test_sincos32_kernel_equals_its_plain_version(card):
    rng = np.random.default_rng(17)
    ang = rng.uniform(-8.0, 8.0, 2**16).astype(F32)
    got = fp32.sincos32(torch.from_numpy(ang).to(card))
    want = fp32.sincos32_plain(torch.from_numpy(ang))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g.cpu().numpy()),
                                      bits(w.numpy()))


@pytest.mark.cuda
def test_rodrigues_and_rot_uncertainty_kernels_equal_their_plain_versions(
        card):
    from goicp_tpu_torch.bounds.evaluate import (rot_uncertainty,
                                                 rot_uncertainty_plain)
    from goicp_tpu_torch.geom.rotation import rodrigues, rodrigues_plain
    rng = np.random.default_rng(18)
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    v = np.concatenate([np.zeros((1, 3)), axes * math.pi / 2, axes * math.pi,
                        axes * math.pi * (1 + 2.0**-20),
                        [[math.pi] * 3],
                        rng.uniform(-math.pi, math.pi, (4096, 3))]).astype(F32)
    before = fp32.rodrigues_kernel.launches
    got = rodrigues(torch.from_numpy(v).to(card)).cpu()
    assert fp32.rodrigues_kernel.launches == before + 1
    np.testing.assert_array_equal(
        bits(got.numpy()), bits(rodrigues_plain(torch.from_numpy(v))))
    w = np.concatenate([[2 * math.pi / 2**k for k in range(13)], [0.0],
                        rng.uniform(0.0, 8.0, 16)]).astype(F32)
    nd = np.concatenate([[0.0], rng.uniform(0.05, 1.2, 191)]).astype(F32)
    before = fp32.rot_uncertainty_kernel.launches
    got = rot_uncertainty(torch.from_numpy(w).to(card),
                          torch.from_numpy(nd).to(card)).cpu()
    assert fp32.rot_uncertainty_kernel.launches == before + 1
    np.testing.assert_array_equal(
        bits(got.numpy()),
        bits(rot_uncertainty_plain(torch.from_numpy(w), torch.from_numpy(nd))))


@pytest.mark.cuda
def test_cross3_kernel_equals_its_plain_version_in_six_layouts(card):
    rng = np.random.default_rng(19)
    A = torch.from_numpy(rng.normal(size=(16, 3, 3)).astype(F32))
    B = torch.from_numpy(rng.normal(size=(16, 3, 3)).astype(F32))
    for a, b in ((A[:, 0], B[:, 1]), (A[:, :, 0], B[:, 1]),
                 (A[:, 0], B[:1, 2]), (A[0, :, 2], B[:, :, 0]),
                 (A[0, 0], B[0, :, 1]), (A[:4, :, None, :], B[:4, None])):
        ca = A.to(card).as_strided(a.shape, a.stride(), a.storage_offset())
        cb = B.to(card).as_strided(b.shape, b.stride(), b.storage_offset())
        got = fp32.cross3(ca, cb).cpu()
        want = fp32.cross3_plain(a, b)
        assert got.shape == want.shape
        np.testing.assert_array_equal(bits(got.numpy()), bits(want.numpy()))
