"""The port's fixed float32 order (goicp_tpu_torch/utils/fp32.py) against
numpy specifications written from its docstring, bit for bit: the
ordered sum, the bound kernels' plain twins in every mode, the 3x3
products, norms, cross products and sincos32's sin and cos.  An
ICP event and a rescoring give the same bits under 1 and 4 intra-op
threads.  The Kabsch equals the JAX package's kabsch_from_H run op by op
on the correspondence matrix at which syn72's registration first splits
from the jitted JAX one.  The products that have a kernel of their own
(csrc/fp32_products.cu: sq_dist3, det3, cross3, dot_fma) equal, in their plain
versions, a numpy transcription of the kernel's arithmetic, and dot_fma's
shape description walks broadcast operands as the kernel walks them.  On a
card, each kernel equals its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goicp_tpu.icp import icp as jicp
from goicp_tpu_torch.bounds.cuda_eval import SQRT3, reduce_bounds
from goicp_tpu_torch.bounds.error import score_transform
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.geom.rotation import rodrigues_np
from goicp_tpu_torch.icp import icp as ticp
from goicp_tpu_torch.pipeline.prepare import make_count_dynamic, prepare_pair
from goicp_tpu_torch.utils import fp32
from tests.test_search import _FAST, _synth

torch.set_num_threads(1)

F32 = np.float32
LENGTHS = [1, 2, 3, 4, 5, 17, 31, 32, 33, 63, 64, 65, 100, 255, 256, 257,
           300]


def bits(x):
    return np.asarray(x, F32).view(np.int32)


def np_ordered_sum(x, lanes=32):
    """fp32.py's order from its docstring: pad with +0.0 to (J, lanes),
    lane t adds x[t], x[t + lanes], ... from +0.0, then the xor butterfly
    acc[t] + acc[t ^ off] for off = lanes/2 .. 1; lane 0.  numpy float32
    adds, one rounding each."""
    x = np.asarray(x, F32)
    n = x.shape[-1]
    J = max(1, -(-n // lanes))
    acc = np.zeros(x.shape[:-1] + (lanes,), F32)
    for j in range(J):
        for t in range(lanes):
            i = j * lanes + t
            acc[..., t] = acc[..., t] + (x[..., i] if i < n else F32(0.0))
    off = lanes // 2
    while off:
        acc = acc + acc[..., np.arange(lanes) ^ off]
        off //= 2
    return acc[..., 0]


def np_fma(a, b, c):
    """A correctly rounded float32 FMA a*b + c, as fp32.dot_fma takes it:
    the float64 sum (the product exact there) rounded to odd, its error
    found by TwoSum, then rounded once to float32."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    step = (e != 0) & ((s.view(np.int64) & 1) == 0)
    return np.where(step, np.nextafter(s, np.copysign(np.inf, e)),
                    s).astype(F32)


def np_dot_fma(a, b):
    a, b = np.broadcast_arrays(np.asarray(a, F32), np.asarray(b, F32))
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = np_fma(a[..., k], b[..., k], acc)
    return acc


def _rows(n, seed, rows=64):
    """Seeded rows of length n over twelve decades, both signs, with zeros,
    -0.0 and subnormals."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, n))
         * 10.0 ** rng.uniform(-6, 6, size=(rows, n))).astype(F32)
    x[rng.random((rows, n)) < 0.1] = 0.0
    x[rng.random((rows, n)) < 0.05] = -0.0
    sub = rng.random((rows, n)) < 0.05
    x[sub] = (rng.normal(size=int(sub.sum())) * 1e-39).astype(F32)
    x[0] = -0.0                        # a row of -0.0 sums to +0.0
    return x


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("n", LENGTHS)
def test_ordered_sum_equals_its_numpy_spec(n, lanes):
    x = _rows(n, seed=n)
    want = np_ordered_sum(x, lanes)
    got = fp32.ordered_sum(torch.from_numpy(x), -1, lanes).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))
    assert bits(got)[0] == 0            # +0.0, not -0.0
    # the same order over another axis
    got0 = fp32.ordered_sum(torch.from_numpy(np.ascontiguousarray(x.T)), 0,
                            lanes).numpy()
    np.testing.assert_array_equal(bits(got0), bits(want))


def test_ordered_sum_is_independent_of_the_thread_count():
    x = torch.from_numpy(_rows(300, seed=5, rows=4096) * F32(1e-3))
    got = {}
    for threads in (1, 4):
        torch.set_num_threads(threads)
        try:
            got[threads] = (fp32.ordered_sum(x).numpy(),
                            fp32.ordered_sum(x, 0).numpy())
        finally:
            torch.set_num_threads(1)
    for a, b in zip(got[1], got[4]):
        np.testing.assert_array_equal(bits(a), bits(b))


def test_ordered_sum_refuses_other_types_and_lane_counts():
    with pytest.raises(TypeError):
        fp32.ordered_sum(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        fp32.ordered_sum(torch.zeros(4), lanes=3)


def np_reduce_bounds(dis, widths, ru, norm, fused, mask=None, K=None):
    """bounds/cuda_eval.py::reduce_bounds from K1/K3's source: sums in the
    warp order, trimmed sums as sum_k_smallest takes them (the K-th
    smallest real value, the values below it, the ties)."""
    def f(v):
        return v * v if norm == 2 else v
    s3w = (F32(SQRT3 / 2.0) * widths)[:, :, None]

    def lbf(v):
        return f(np.maximum(v - s3w, F32(0.0)))

    def sums(v, *fs):
        if K is None:
            return [np_ordered_sum(g(v)) for g in fs]
        if K == 0:
            return [np.zeros(v.shape[:-1], F32) for _ in fs]
        vals = np.where(mask, v, F32(np.inf))
        kth = np.sort(vals, axis=-1)[..., K - 1:K]
        below = vals < kth
        ties = (K - below.sum(axis=-1)).astype(F32)
        return [np_ordered_sum(np.where(below, g(vals), F32(0.0)))
                + ties * g(kth)[..., 0] for g in fs]

    if fused:
        disu = np.maximum(dis if ru is None else dis - ru[:, None, :],
                          F32(0.0))
        return (*sums(dis, f), *sums(disu, f, lbf))
    if ru is not None:
        dis = dis - ru[:, None, :]
    return tuple(sums(np.maximum(dis, F32(0.0)), f, lbf))


def _bound_inputs(nd, seed):
    """(dis, widths, rot_unc, mask): weighted distances with ties and
    zero-weight padding, as the bound kernels see them."""
    rng = np.random.default_rng(seed)
    L, B = 3, 5
    d = rng.integers(0, 40, size=(L, B, nd)).astype(F32) * F32(0.0371)
    w = rng.uniform(0.5, 2.0, size=nd).astype(F32)
    w[rng.random(nd) < 0.15] = 0.0
    dis = w[None, None, :] * d
    widths = rng.uniform(0.01, 0.4, size=(L, B)).astype(F32)
    ru = rng.uniform(0.0, 0.3, size=(L, nd)).astype(F32)
    return dis, widths, ru, (w > 0)[None, None, :]


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("mode", [
    "fused", "fused_static", "fused_dynamic", "fused_dynamic_0",
    "fused_dynamic_all", "plain", "plain_no_unc", "plain_static",
    "plain_dynamic"])
@pytest.mark.parametrize("nd", [70, 300])
def test_reduce_bounds_equals_the_kernels_order(mode, norm, nd):
    dis, widths, ru, mask = _bound_inputs(nd, seed=nd + norm)
    fused = mode.startswith("fused")
    if mode == "plain_no_unc":
        ru = None
    real = int(mask.sum())
    kf = {"dynamic": F32(0.8 * real + 0.3), "dynamic_0": F32(0.0),
          "dynamic_all": F32(nd + 5)}
    k = K = None
    static = False
    if mode.endswith("static"):
        k = K = int(0.8 * real)
        static = True
    elif "dynamic" in mode:
        v = kf[mode.split("_", 1)[1]]
        k = torch.tensor(v)
        K = 0 if not v > 0 else (nd if v >= nd else int(np.ceil(v)))
    want = np_reduce_bounds(dis, widths, ru, norm, fused,
                            mask=mask, K=K)
    got = reduce_bounds(torch.from_numpy(dis), torch.from_numpy(widths),
                        None if ru is None else torch.from_numpy(ru), norm,
                        fused, mask=torch.from_numpy(mask), k=k,
                        static=static)
    assert len(got) == len(want) == (3 if fused else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w))


def test_products_norms_and_trig_equal_numpy_step_by_step():
    rng = np.random.default_rng(3)
    R = rng.normal(size=(8, 3, 3)).astype(F32)
    A = rng.normal(size=(8, 3, 3)).astype(F32)
    pts = rng.uniform(-0.8, 0.8, size=(50, 3)).astype(F32)
    v = (rng.normal(size=(4000, 3))
         * 10.0 ** rng.uniform(-3, 3, size=(4000, 1))).astype(F32)
    vr = v[::-1].copy()
    tR, tA, tp, tv, tvr = map(torch.from_numpy, (R, A, pts, v, vr))
    cases = {
        "rotate": (fp32.rotate(tR, tp),
                   np_ordered_sum(R[:, None, :, :] * pts[None, :, None, :])),
        "matmul3": (fp32.matmul3(tR, tA),
                    np_ordered_sum(R[:, :, None, :]
                                   * np.swapaxes(A, 1, 2)[:, None, :, :])),
        "matvec3": (fp32.matvec3(tR, tA[:, 0]),
                    np_ordered_sum(R * A[:, 0][:, None, :])),
        "dot3": (fp32.dot3(tv, tvr), np_ordered_sum(v * vr)),
        "norm3": (fp32.norm3(tv),
                  np.sqrt(np_dot_fma(v, v).astype(np.float64)).astype(F32)),
        "dot_fma": (fp32.dot_fma(tR[:, :, None, :], tA[:, None, :, :]),
                    np_dot_fma(R[:, :, None, :], A[:, None, :, :])),
        "cross3": (fp32.cross3(tv, tvr),
                   np.stack([v[:, 1] * vr[:, 2] - v[:, 2] * vr[:, 1],
                             v[:, 2] * vr[:, 0] - v[:, 0] * vr[:, 2],
                             v[:, 0] * vr[:, 1] - v[:, 1] * vr[:, 0]],
                            axis=-1)),
    }
    ang = rng.uniform(-4.0, 4.0, size=4096).astype(F32)
    sin32, cos32 = fp32.sincos32(torch.from_numpy(ang))
    cases["sincos32, cos"] = (cos32,
                              np.cos(ang.astype(np.float64)).astype(F32))
    cases["sincos32, sin"] = (sin32,
                              np.sin(ang.astype(np.float64)).astype(F32))
    for name, (got, want) in cases.items():
        np.testing.assert_array_equal(bits(got.numpy()), bits(want),
                                      err_msg=name)
    # dot3's order, spelled out
    p = v * vr
    np.testing.assert_array_equal(
        bits(cases["dot3"][0].numpy()),
        bits((p[:, 0] + p[:, 2]) + p[:, 1] + F32(0.0)))


def _icp_and_score():
    """One ICP event from four seeds on a padded, count-dynamic, trimmed
    pair, and the rescoring of its results."""
    data, model, props, *_ = _synth(60, 1)
    cfg = GoICPConfig(**_FAST, trimFraction=0.1)
    pair = make_count_dynamic(prepare_pair(data, model, props, props, cfg,
                                           pad_data_to=64, device="cpu"))
    rng = np.random.default_rng(11)
    R0 = torch.as_tensor(np.stack([rodrigues_np(rng.uniform(-0.3, 0.3, 3))
                                   for _ in range(4)]), dtype=torch.float32)
    t0 = torch.as_tensor(rng.uniform(-0.05, 0.05, (4, 3)),
                         dtype=torch.float32)
    r = ticp.icp_run(pair.data, pair.model, R0, t0,
                     inlier_num=pair.inlier_num, max_iter=30,
                     err_diff=cfg.err_diff, data_mask=pair.data_mask,
                     count=pair.inlier_f(), dynamic_trim=True)
    return r, score_transform(pair, cfg, r.R, r.t, r.nn_idx)


def test_icp_event_and_score_are_independent_of_the_thread_count():
    got = {}
    for threads in (1, 4):
        torch.set_num_threads(threads)
        try:
            got[threads] = _icp_and_score()
        finally:
            torch.set_num_threads(1)
    (r1, s1), (r4, s4) = got[1], got[4]
    assert int(r1.iters.max()) > 1
    for name, a, b in [*zip(r1._fields, r1, r4), *zip(s1._fields, s1, s4)]:
        a, b = a.numpy(), b.numpy()
        if a.dtype == np.float32:
            a, b = bits(a), bits(b)
        np.testing.assert_array_equal(a, b, err_msg=name)


# The correspondence matrix H (float32 bits) of syn72's first ICP split:
# at outer step 34 the JAX package's jitted ICP and the port first give
# different rotations, and the incumbents part by one ulp.  Jitted, XLA:CPU
# computes the Kabsch's 1/sqrt as a hardware rsqrt estimate refined by two
# Newton steps; run op by op it computes what the port computes.
SYN72_SPLIT_H = [[1101823910, -1088907986, -1065431664],
                 [-1092715614, 1101293741, 1035546867],
                 [-1064923639, 1052439365, 1102160679]]


def test_kabsch_equals_jax_op_by_op_on_syn72s_split():
    H = np.array(SYN72_SPLIT_H, np.int32).view(F32)
    with jax.disable_jit():
        want = np.asarray(jicp.kabsch_from_H(jnp.asarray(H)))
    got = ticp.kabsch_from_H(torch.from_numpy(H.copy())).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))


def np_dot3_kernel(a, b):
    """csrc/fp32_products.cu's dot3: (z0 + z2) + z1, z_k = +0 + a_k b_k."""
    z = F32(0.0) + np.asarray(a, F32) * np.asarray(b, F32)
    return (z[..., 0] + z[..., 2]) + z[..., 1]


def np_sq_dist3_kernel(p, q):
    pp = np_dot3_kernel(p, p)[..., None]
    return (pp - F32(2.0) * np_dot3_kernel(p[..., :, None, :], q)
            + np_dot3_kernel(q, q))


def np_det3_kernel(M):
    u, v = M[..., 1, :], M[..., 2, :]
    c = [u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
         u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
         u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]]
    acc = F32(0.0) + M[..., 0, 0] * c[0]
    acc = acc + M[..., 0, 1] * c[1]
    return acc + M[..., 0, 2] * c[2]


def np_dot_fma_kernel(fa, fb, meta):
    """The dot_fma kernel's walk: row r's leading index from the sizes
    (last fastest), each operand's offset from its strides, over the flat
    storage fa, fb of its operands."""
    d = fp32._DIMS
    size, sa, sb = meta[:d], meta[d:2 * d], meta[2 * d:3 * d]
    la, lb, n = meta[3 * d:]
    out = []
    for r in range(int(np.prod(size))):
        oa = ob = 0
        for k in reversed(range(d)):
            r, i = divmod(r, size[k])
            oa, ob = oa + i * sa[k], ob + i * sb[k]
        acc = fa[oa] * fb[ob]
        for k in range(1, n):
            acc = np_fma(fa[oa + k * la], fb[ob + k * lb], acc)
        out.append(acc)
    return np.array(out, F32).reshape(size)


def np_cross3_kernel(fa, fb, meta):
    """The cross3 kernel's walk (np_dot_fma_kernel's), entry k the
    difference of the products x[k+1] y[k+2] and x[k+2] y[k+1]."""
    d = fp32._DIMS
    size, sa, sb = meta[:d], meta[d:2 * d], meta[2 * d:3 * d]
    la, lb, n = meta[3 * d:]
    assert n == 3
    out = []
    for r in range(int(np.prod(size))):
        oa = ob = 0
        for k in reversed(range(d)):
            r, i = divmod(r, size[k])
            oa, ob = oa + i * sa[k], ob + i * sb[k]
        x = [fa[oa + k * la] for k in range(3)]
        y = [fb[ob + k * lb] for k in range(3)]
        out.append([x[(k + 1) % 3] * y[(k + 2) % 3]
                    - x[(k + 2) % 3] * y[(k + 1) % 3] for k in range(3)])
    return np.array(out, F32).reshape(tuple(size) + (3,))


def _product_inputs(seed):
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-0.8, 0.8, (4, 40, 3))).astype(F32)
    pts[0, :3] = [[0.0, -0.0, 0.0], [-0.0, -0.0, -0.0], [1e-39, -2e-39, 0.0]]
    model = rng.uniform(-0.8, 0.8, (33, 3)).astype(F32)
    model[0] = -0.0
    mats = rng.normal(size=(64, 3, 3)).astype(F32)
    mats[0] = 0.0
    mats[1, 2] = mats[1, 1]                 # singular
    return pts, model, mats


@pytest.mark.parametrize("kernel", ["sq_dist3", "det3"])
def test_product_kernels_arithmetic_equals_their_plain_versions(kernel):
    pts, model, mats = _product_inputs(seed=21)
    if kernel == "sq_dist3":
        got = fp32.sq_dist3(torch.from_numpy(pts), torch.from_numpy(model))
        want = np_sq_dist3_kernel(pts, model)
    else:
        got = fp32.det3(torch.from_numpy(mats))
        want = np_det3_kernel(mats)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


@pytest.mark.parametrize("kernel", ["dot_fma", "cross3"])
@pytest.mark.parametrize("case", ["kabsch", "norm3", "rows"])
def test_broadcast_kernels_walk_equals_their_plain_versions(case, kernel):
    rng = np.random.default_rng(23)
    A = torch.from_numpy(rng.normal(size=(4, 3, 3)).astype(F32))
    B = torch.from_numpy(rng.normal(size=(4, 3, 3)).astype(F32))
    if case == "kabsch":       # R = V (d U)^T, as kabsch_from_H takes it
        base, a, b = (A, B), A[..., :, None, :], B[..., None, :, :]
    elif case == "norm3":
        base = (A.reshape(-1, 3),) * 2
        a = b = base[0]
    else:                      # a (2, 6, 3) against one broadcast row
        v = torch.from_numpy(rng.normal(size=(2, 6, 3)).astype(F32))
        base, a, b = (v, B), v, B[0, 0]
    a, b = torch.broadcast_tensors(a, b)
    meta = fp32.broadcast_meta(a, b)
    fn, walk = ((fp32.dot_fma, np_dot_fma_kernel) if kernel == "dot_fma"
                else (fp32.cross3, np_cross3_kernel))
    want = fn(a, b).numpy()
    got = walk(base[0].reshape(-1).numpy(), base[1].reshape(-1).numpy(),
               meta)
    np.testing.assert_array_equal(bits(got.reshape(want.shape)), bits(want))


def test_fixed_order_kernels_refuse_other_devices_and_types():
    with pytest.raises(ValueError):
        fp32.sq_dist3(torch.zeros(2, 3), torch.zeros(2, 3, device="meta"))
    with pytest.raises(ValueError):
        fp32.dot_fma(torch.zeros(2, 1, 1, 1, 1, 3, device="meta"),
                     torch.zeros(3, device="meta"))


@pytest.mark.cuda
def test_product_kernels_equal_their_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pts, model, mats = _product_inputs(seed=21)
    tp, tm, tM = map(torch.from_numpy, (pts, model, mats))
    V, U = tM[:8], tM[8:16]
    cases = [(fp32.sq_dist3, (tp, tm)), (fp32.det3, (tM,)),
             (fp32.dot_fma, (V[..., :, None, :], U[..., None, :, :])),
             (fp32.dot_fma, (tp, tp)),
             (fp32.cross3, (tM[:, :, 0], tM[:, 1])),
             (fp32.cross3, (tp, tm[0]))]
    for fn, args in cases:
        got = fn(*(x.cuda() for x in args)).cpu()
        want = fn(*args)
        np.testing.assert_array_equal(bits(got.numpy()), bits(want.numpy()),
                                      err_msg=fn.__name__)


@pytest.mark.cuda
def test_ordered_sum_kernel_equals_its_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n in LENGTHS:
        x = torch.from_numpy(_rows(n, seed=n))
        for lanes in fp32.LANES:
            for dim in (0, 1):
                got = fp32.ordered_sum(x.cuda(), dim, lanes).cpu()
                want = fp32.ordered_sum_plain(x, dim, lanes)
                np.testing.assert_array_equal(bits(got.numpy()),
                                              bits(want.numpy()))
