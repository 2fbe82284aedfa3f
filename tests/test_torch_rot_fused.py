"""rodrigues and rot_uncertainty, one launch each on the card
(utils/fp32.py's rodrigues_kernel and rot_uncertainty_kernel,
csrc/fp32_products.cu; their bodies csrc/rot_body.cuh's rodrigues_of and
rot_unc_of), held on the CPU:

  * rodrigues_plain equals the JAX package's rodrigues on XLA:CPU to 2e-7
    (seeded centres in the pi-ball, the zero vector, the axes, |v| = pi
    and the cube's corner, |v| = sqrt(3) pi), and a numpy float32 model
    of rodrigues_of's operations in rot_body.cuh's order equals it bit for
    bit: the kernel's order is torch's;
  * rot_uncertainty_plain equals the JAX package's rot_uncertainty to
    1e-6 relative at the BnB's widths 2 pi / 2^k (k = 0..12) and 64 point
    norms, and a numpy model of the kernel's seven steps equals it bit
    for bit;
  * both route CPU tensors to their plain versions, launching nothing.

The kernels themselves are held to these plain versions on the card by
tests/test_torch_fp32_fused.py's `cuda` tests and chip_smoke.py phase 2.
"""

import math

import numpy as np
import pytest
import torch

from goicp_tpu_torch.bounds import evaluate as tev
from goicp_tpu_torch.geom import rotation as trot
from goicp_tpu_torch.utils import fp32

torch.set_num_threads(1)

F32 = np.float32


def bits(x):
    return np.asarray(x, F32).view(np.int32)


def rotation_vectors(case):
    """float32 angle-axis vectors of one kind."""
    rng = np.random.default_rng(21)
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    unit = rng.normal(size=(8, 3))
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    v = {"seeded": lambda: unit * rng.uniform(0, math.pi, (8, 1)),
         "zero": lambda: np.zeros((2, 3)),
         "axes": lambda: np.concatenate([axes * math.pi / 2,
                                         axes * rng.uniform(0, 3, (6, 1))]),
         "pi": lambda: np.concatenate([axes * math.pi, unit * math.pi,
                                       axes * math.pi * (1 - 2.0**-20)]),
         "sqrt3 pi": lambda: np.array([[1, 1, 1], [-1, 1, -1],
                                       [1, -1, -1]]) * math.pi,
         "cube": lambda: rng.uniform(-math.pi, math.pi, (512, 3))}[case]()
    return v.astype(F32)


CASES = ["seeded", "zero", "axes", "pi", "sqrt3 pi"]


@pytest.mark.parametrize("case", CASES)
def test_rodrigues_plain_equals_jax(case):
    import jax.numpy as jnp
    from goicp_tpu.geom.rotation import rodrigues
    v = rotation_vectors(case)
    got = trot.rodrigues_plain(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(rodrigues(jnp.asarray(v))),
                               rtol=0, atol=2e-7)
    assert torch.equal(trot.rodrigues(torch.from_numpy(v)),
                       torch.from_numpy(got))


# ---------------------------------------------------------------------------
# numpy models of the kernels' operations, one rounding each
# ---------------------------------------------------------------------------

def fma32(a, b, c):
    """float32 a b + c rounded once: the float64 sum of the exact product
    and c, rounded to odd (TwoSum, then a step to the odd neighbour where
    inexact), then rounded to float32 (__fmaf_rn)."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    step = (e != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(step, np.nextafter(s, np.copysign(np.inf, e)), s)
    return s.astype(F32)


def norm3_of(v):
    """rot_body.cuh's norm3_of: fma(z, z, fma(y, y, x x)), then the
    correctly rounded square root (through float64, exact for float32)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    acc = fma32(z, z, fma32(y, y, x * x))
    return np.sqrt(acc.astype(np.float64)).astype(F32)


def sincos32(x):
    """fp32_order.cuh's sincos32: each float64 operation rounded once in
    its order, each result rounded once to float32."""
    t = x.astype(np.float64)
    k = np.rint(t * fp32._TWO_OVER_PI)
    r = (t - k * fp32._PIO2_HI) - k * fp32._PIO2_LO
    z = r * r

    def horner(cs):
        p = np.full_like(z, cs[-1])
        for c in reversed(cs[:-1]):
            p = p * z + c
        return p
    sr = r + (r * z) * horner(fp32._SIN_C)
    cr = 1.0 + z * horner(fp32._COS_C)
    q = k.astype(np.int64) & 3
    odd = (q & 1) == 1
    sv, cv = np.where(odd, cr, sr), np.where(odd, sr, cr)
    return (np.where((q & 2) == 2, -sv, sv).astype(F32),
            np.where((q == 1) | (q == 2), -cv, cv).astype(F32))


def rodrigues_of(v):
    """rot_body.cuh's rodrigues_of after norm3_of, in float32 numpy."""
    t = norm3_of(v)[:, None]
    pos = t > 0
    u = np.where(pos, v / np.where(pos, t, F32(1)), F32(0))
    st, ct = sincos32(t[:, 0])
    one_ct = F32(1) - ct
    ux, uy, uz = u[:, 0], u[:, 1], u[:, 2]
    zero = np.zeros_like(ux)
    K = np.stack([np.stack([zero, -uz, uy], -1), np.stack([uz, zero, -ux], -1),
                  np.stack([-uy, ux, zero], -1)], -2)
    R = np.empty((len(v), 3, 3), F32)
    for i in range(3):
        for j in range(3):
            e = F32(1 if i == j else 0)
            a = ct * e + st * K[:, i, j]
            R[:, i, j] = a + one_ct * (u[:, i] * u[:, j])
    return R


@pytest.mark.parametrize("case", CASES + ["cube"])
def test_rodrigues_of_model_equals_plain_bit_for_bit(case):
    v = rotation_vectors(case)
    np.testing.assert_array_equal(
        bits(rodrigues_of(v)),
        bits(trot.rodrigues_plain(torch.from_numpy(v)).numpy()))


def bnb_widths():
    return np.array([2 * math.pi / 2**k for k in range(13)], F32)


def point_norms(n=64):
    rng = np.random.default_rng(22)
    return np.concatenate([[0.0], rng.uniform(0.05, 1.2, n - 1)]).astype(F32)


def test_rot_uncertainty_plain_equals_jax():
    import jax.numpy as jnp
    from goicp_tpu.bounds.evaluate import rot_uncertainty
    w, nd = bnb_widths(), point_norms()
    got = tev.rot_uncertainty_plain(torch.from_numpy(w),
                                    torch.from_numpy(nd)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(rot_uncertainty(jnp.asarray(w), jnp.asarray(nd))),
        rtol=1e-6, atol=0)
    assert torch.equal(tev.rot_uncertainty(torch.from_numpy(w),
                                           torch.from_numpy(nd)),
                       torch.from_numpy(got))


def rot_unc_of(w, nd):
    """rot_body.cuh's rot_unc_of, its seven steps in float32 numpy."""
    a = F32(math.sqrt(3.0)) * w                 # 1. float(sqrt 3) w
    a = a / F32(2)                              # 2. / 2
    a = np.where(np.isnan(a), a, np.minimum(a, F32(math.pi)))  # 3. clamp
    a = a / F32(2)                              # 4. / 2
    s = sincos32(a)[0]                          # 5. the sine
    s2 = F32(2) * s                             # 6. 2 s
    return s2[:, None] * nd[None, :]            # 7. times the norm


def test_rot_unc_model_equals_plain_bit_for_bit():
    rng = np.random.default_rng(23)
    w = np.concatenate([bnb_widths(), [0.0, np.inf],
                        rng.uniform(0.0, 8.0, 32)]).astype(F32)
    nd = point_norms()
    np.testing.assert_array_equal(
        bits(rot_unc_of(w, nd)),
        bits(tev.rot_uncertainty_plain(torch.from_numpy(w),
                                       torch.from_numpy(nd)).numpy()))


@pytest.mark.parametrize("fn", ["rodrigues", "rot_uncertainty"])
def test_new_wrappers_route_cpu_to_plain_and_refuse_other_devices(fn):
    v = torch.from_numpy(rotation_vectors("seeded"))
    w, nd = torch.from_numpy(bnb_widths()), torch.from_numpy(point_norms())
    wrapper, plain, kern, args = {
        "rodrigues": (trot.rodrigues, trot.rodrigues_plain,
                      fp32.rodrigues_kernel, (v,)),
        "rot_uncertainty": (tev.rot_uncertainty, tev.rot_uncertainty_plain,
                            fp32.rot_uncertainty_kernel, (w, nd))}[fn]
    before = kern.launches
    assert torch.equal(wrapper(*args), plain(*args))
    assert kern.launches == before
    with pytest.raises(ValueError):
        wrapper(*(x.to("meta") for x in args))
