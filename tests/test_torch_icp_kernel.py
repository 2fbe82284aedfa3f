"""The ICP kernel (goicp_tpu_torch/csrc/icp.cu) against the plain ICP, bit
for bit.  numpy float32 transcriptions of the kernel's Kabsch
(goicp_kabsch3) and of its ICP event (goicp_icp_run), statement by
statement, are held to icp.py::kabsch_from_H and icp_run_plain on the
CPU: on H that is zero, rank 1, rank 2 or a reflection, and in every
mask mode, with rows that stop at different iterations and at max_iter 0
and 1.  icp_run's dispatch: CPU tensors take the plain loop, other
devices or a mix raise.  On a card, each kernel equals its plain version
on the same card tensors."""

import numpy as np
import pytest
import torch

from goicp_tpu_torch.geom.rotation import rodrigues_np
from goicp_tpu_torch.icp import icp as ticp

torch.set_num_threads(1)

F32 = np.float32
ZERO, ONE = F32(0.0), F32(1.0)


def bits(x):
    return np.asarray(x, F32).view(np.int32)


# ---------------------------------------------------------------------------
# the kernel's arithmetic in numpy float32 (every op one rounding)
# ---------------------------------------------------------------------------

def sqrt_rn(x):
    """__fsqrt_rn: the correctly rounded float32 square root."""
    return F32(np.sqrt(np.float64(x)))


def dot3_seq(a, b):
    acc = ZERO + a[0] * b[0]
    acc = acc + a[1] * b[1]
    return acc + a[2] * b[2]


def dot3_warp(a, b):
    """(z0 + z2) + z1, z_k = +0 + a_k b_k; vectorized over leading axes."""
    z0, z1, z2 = (ZERO + a[..., k] * b[..., k] for k in range(3))
    return (z0 + z2) + z1


def cross3(x, y):
    return [x[(k + 1) % 3] * y[(k + 2) % 3] - x[(k + 2) % 3] * y[(k + 1) % 3]
            for k in range(3)]


def det3_rows(M):
    return dot3_seq(M[0], cross3(M[1], M[2]))


def dot_fma_step(a, b, acc):
    """__fmaf_rn(a, b, acc): a b + acc rounded once to float32 (the float64
    sum rounded to odd by TwoSum, then to float32)."""
    p, c = np.float64(a) * np.float64(b), np.float64(acc)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    if e != 0 and np.array(s).view(np.int64) & 1 == 0:
        s = np.nextafter(s, np.copysign(np.inf, e))
    return F32(s)


def clamp_min(x, lo):
    return lo if x < lo else x


def sign_of(x):
    return ONE if x > 0 else (F32(-1.0) if x < 0 else ZERO)


def argmin3(v):
    k, best = 0, v[0]
    for j in (1, 2):
        if not np.isnan(best) and (v[j] < best or np.isnan(v[j])):
            k, best = j, v[j]
    return k


# how often each of the kernel's shortcuts in givens() was taken
GIVENS_PATHS = {"rotations": 0, "root = |tau|": 0, "c = 1": 0}


def givens(A, V, p, q):
    """The kernel's givens<P, Q>: its exact shortcuts (not safe: t = 0, c =
    1; root = |tau| where 1 + tau^2 rounds to a finite tau^2; c = 1 where
    1 + t^2 rounds to 1)."""
    ap, aq = A[:, p].copy(), A[:, q].copy()
    app, aqq, apq = dot3_seq(ap, ap), dot3_seq(aq, aq), dot3_seq(ap, aq)
    t, c = ZERO, ONE
    GIVENS_PATHS["rotations"] += 1
    if abs(apq) > F32(1e-30):
        tau = (aqq - app) / (F32(2.0) * apq)
        tau2 = tau * tau
        y = ONE + tau2
        if y == tau2 and np.isfinite(tau2):
            root = abs(tau)
            GIVENS_PATHS["root = |tau|"] += 1
        else:
            root = sqrt_rn(y)
        t = sign_of(tau) / (abs(tau) + root)
        z = ONE + t * t
        if z != ONE:
            c = ONE / sqrt_rn(z)
        else:
            GIVENS_PATHS["c = 1"] += 1
    s = t * c
    for M in (A, V):
        mp, mq = M[:, p].copy(), M[:, q].copy()
        for i in range(3):
            M[i, p] = c * mp[i] - s * mq[i]
            M[i, q] = s * mp[i] + c * mq[i]


def np_kabsch3(H):
    """icp.cu's kabsch_from_H on one row-major (3, 3) float32 H."""
    with np.errstate(all="ignore"):
        return _np_kabsch3(np.asarray(H, F32))


def _np_kabsch3(H):
    hmax = abs(H[0, 0])
    for a in np.abs(H).reshape(-1)[1:]:
        if np.isnan(a) or a > hmax:
            hmax = a
    scale = clamp_min(hmax, F32(1e-30))
    A = H / scale
    V = np.eye(3, dtype=F32)
    for _ in range(6):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            givens(A, V, p, q)
    sigma = np.array([sqrt_rn(dot3_seq(A[:, j], A[:, j]))
                      for j in range(3)], F32)
    for p, q in ((0, 1), (0, 2), (1, 2)):
        if sigma[p] < sigma[q]:
            A[:, [p, q]] = A[:, [q, p]]
            V[:, [p, q]] = V[:, [q, p]]
            sigma[[p, q]] = sigma[[q, p]]
    s1 = sigma[0]
    for k in (1, 2):
        if np.isnan(sigma[k]) or sigma[k] > s1:
            s1 = sigma[k]
    tol = F32(1e-5) * clamp_min(s1, F32(1e-30))
    u = [[A[i, j] / clamp_min(sigma[j], F32(1e-30)) for i in range(3)]
         for j in range(3)]
    ei = argmin3([abs(x) for x in u[0]])
    e = [ONE if k == ei else ZERO for k in range(3)]
    alt1 = cross3(u[0], e)
    norm = clamp_min(sqrt_rn(dot3_seq(alt1, alt1)), F32(1e-30))
    alt1 = [x / norm for x in alt1]
    if not sigma[1] > tol:
        u[1] = alt1
    if not sigma[2] > tol:
        u[2] = cross3(u[0], u[1])
    U = np.array(u, F32).T
    det = det3_rows(V) * det3_rows(U)
    small = argmin3(sigma)
    dU = np.array([[(det if k == small else ONE) * U[j, k] for k in range(3)]
                   for j in range(3)], F32)
    R = np.eye(3, dtype=F32)
    if hmax > 0:
        for i in range(3):
            for j in range(3):
                acc = V[i, 0] * dU[j, 0]
                acc = dot_fma_step(V[i, 1], dU[j, 1], acc)
                R[i, j] = dot_fma_step(V[i, 2], dU[j, 2], acc)
    return R


def warp_ordered_sum(terms):
    """One warp's sum: lane t adds terms t, t+32, ... from +0.0, then the
    xor butterfly 16 ... 1; lane 0's value."""
    acc = np.zeros(32, F32)
    for i, x in enumerate(np.asarray(terms, F32)):
        acc[i % 32] = acc[i % 32] + x
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[np.arange(32) ^ off]
    return acc[0]


def np_icp_row(data, model, R, t, *, inlier_num, max_iter, err_diff, mode,
               data_mask=None, count=None, enabled=True):
    """One block of goicp_icp_run: one row's iterations until it stops.
    Returns (R, t, nn_idx, err, iters)."""
    nd, m = len(data), len(model)
    R, t = np.array(R, F32), np.array(t, F32)
    dmask = np.ones(nd, F32) if data_mask is None else np.asarray(data_mask,
                                                                  F32)
    qq = dot3_warp(model, model)
    cnt = F32(inlier_num) if count is None else F32(count)
    err, it, idx = F32(-1.0), 0, np.zeros(nd, np.int64)
    run = enabled and max_iter > 0
    while run:
        pts = np.stack([dot3_warp(R[r][None, :], data) + t[r]
                        for r in range(3)], axis=1)
        pp = dot3_warp(pts, pts)
        pq = dot3_warp(pts[:, None, :], model[None, :, :])      # (nd, m)
        d = (pp[:, None] - F32(2.0) * pq) + qq[None, :]
        idx = np.argmin(d, axis=1)
        best = d[np.arange(nd), idx]
        best = np.where(best < 0, ZERO, best)
        if data_mask is not None:
            best = np.where(dmask > 0, best, F32(1.0e12))
        if mode == ticp.MODE_COUNT:
            keep = dmask
        elif mode in (ticp.MODE_TRIM, ticp.MODE_DYN_TRIM):
            j = np.arange(nd)
            rank = ((best[None, :] < best[:, None])
                    | ((best[None, :] == best[:, None])
                       & (j[None, :] < j[:, None]))).sum(axis=1)
            keep = (rank < inlier_num if mode == ticp.MODE_TRIM
                    else rank.astype(F32) < cnt).astype(F32)
        else:
            keep = np.ones(nd, F32)
        mc = model[idx]
        err_new = warp_ordered_sum(best * keep)
        mu_d = np.array([warp_ordered_sum(pts[:, a] * keep) / cnt
                         for a in range(3)], F32)
        mu_m = np.array([warp_ordered_sum(mc[:, a] * keep) / cnt
                         for a in range(3)], F32)
        qd = (pts - mu_d) * keep[:, None]
        qm = (mc - mu_m) * keep[:, None]
        H = np.array([[warp_ordered_sum(qd[:, a] * qm[:, b])
                       for b in range(3)] for a in range(3)], F32)
        conv = err > 0 and err - err_new < F32(err_diff) * cnt
        if not conv:
            Rk = np_kabsch3(H)
            t_ = mu_m - dot3_warp(Rk, mu_d[None, :])
            t = dot3_warp(Rk, t[None, :]) + t_
            R = dot3_warp(Rk[:, None, :], R.T[None, :, :])
        err, it = err_new, it + 1
        run = not conv and it < max_iter
    return R, t, idx, err, it


def np_icp_run(data, model, R0, t0, *, inlier_num, max_iter, err_diff,
               data_mask=None, count=None, dynamic_trim=False, enabled=None):
    """goicp_icp_run: every row its own block."""
    mode = ticp.icp_mode(len(data), inlier_num, count, data_mask,
                         dynamic_trim)
    en = np.ones(len(R0), bool) if enabled is None else np.broadcast_to(
        enabled, (len(R0),))
    rows = [np_icp_row(data, model, R0[k], t0[k], inlier_num=inlier_num,
                       max_iter=max_iter, err_diff=err_diff, mode=mode,
                       data_mask=data_mask, count=count, enabled=bool(en[k]))
            for k in range(len(R0))]
    return ticp.ICPResult(*(np.stack(x) for x in zip(*rows)))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _kabsch_H(kind, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "random":
        q_d = rng.normal(size=(40, 3))
        H = q_d.T @ (q_d @ rodrigues_np(rng.uniform(-2, 2, 3)).T)
    elif kind == "zero":
        H = np.zeros((3, 3))
    elif kind == "rank1":
        H = np.outer(rng.normal(size=3), rng.normal(size=3))
    elif kind == "rank2":
        H = rng.normal(size=(3, 2)) @ rng.normal(size=(2, 3))
    else:
        H = np.diag([1.0, 2.0, -3.0]) @ rodrigues_np(rng.uniform(-1, 1, 3))
    return H.astype(F32)


def _icp_case(mode, K=4, seed=5, n=40, m=44):
    """data (n points, n <= m; 8 more padded in the count modes), model (m
    points), starts at growing distances (rows stop at different
    iterations) and icp_run's keywords for `mode`."""
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.7, 0.7, (m, 3))
    R = rodrigues_np(rng.uniform(-0.3, 0.3, 3))
    data = (model[:n] - rng.uniform(-0.05, 0.05, 3)) @ R \
        + rng.normal(0, 0.003, (n, 3))
    data[:5] = rng.uniform(-0.9, 0.9, (5, 3))                 # outliers
    data, model = data.astype(F32), model.astype(F32)
    kw = dict(inlier_num=n, max_iter=40, err_diff=1e-6)
    enabled = None
    if mode == "trim":
        kw["inlier_num"] = int(n * 0.8)
    if mode in ("mask", "count", "dynamic_trim"):
        pad = 8
        data = np.vstack([data, np.full((pad, 3), 4.0e3, F32)])
        kw["data_mask"] = np.concatenate([np.ones(n), np.zeros(pad)]
                                         ).astype(F32)
        kw["inlier_num"] = n if mode == "mask" else n + pad
        if mode == "count":
            kw["count"] = F32(n)
        if mode == "dynamic_trim":
            kw.update(count=F32(int(n * 0.8)), dynamic_trim=True)
    if mode == "enabled":
        enabled = np.array([True, False, True, True])
    scales = np.linspace(0.02, 0.4, K)
    R0 = np.stack([rodrigues_np(rng.uniform(-1, 1, 3) * s)
                   for s in scales]).astype(F32)
    t0 = (rng.uniform(-1, 1, (K, 3)) * scales[:, None] * 0.2).astype(F32)
    return data, model, R0, t0, kw, enabled


def _torch_kw(kw, enabled, device="cpu"):
    out = {k: (torch.as_tensor(v, device=device)
               if isinstance(v, (np.ndarray, np.floating)) else v)
           for k, v in kw.items()}
    if enabled is not None:
        out["enabled"] = torch.as_tensor(enabled, device=device)
    return out


def _assert_same(got, want):
    for name in ticp.ICPResult._fields:
        g, w = getattr(got, name), getattr(want, name)
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else w
        if g.dtype == np.float32:
            g, w = bits(g), bits(w)
        np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------------------
# the numpy walks against the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "zero", "rank1", "rank2",
                                  "reflection"])
def test_kabsch_walk_equals_kabsch_from_H(kind):
    H = _kabsch_H(kind)
    want = ticp.kabsch_from_H(torch.from_numpy(H)).numpy()
    np.testing.assert_array_equal(bits(np_kabsch3(H)), bits(want))
    np.testing.assert_array_equal(
        bits(ticp.kabsch3(torch.from_numpy(H)).numpy()), bits(want))


def test_kabsch_walk_equals_kabsch_from_H_on_a_batch():
    """64 seeded H of mixed scale, with degenerate and tiny ones; the
    kernel's shortcuts in givens() are taken on the way."""
    rng = np.random.default_rng(31)
    H = (rng.normal(size=(64, 3, 3))
         * 10.0 ** rng.uniform(-6, 3, (64, 1, 1))).astype(F32)
    H[0] = 0.0
    H[1] = np.outer([1, 2, 3], [0, 1e-20, 0])           # tiny rank 1
    H[2, :, 2] = H[2, :, 0]                             # repeated column
    want = ticp.kabsch_from_H(torch.from_numpy(H)).numpy()
    before = dict(GIVENS_PATHS)
    got = np.stack([np_kabsch3(h) for h in H])
    np.testing.assert_array_equal(bits(got), bits(want))
    taken = {k: GIVENS_PATHS[k] - before[k] for k in GIVENS_PATHS}
    assert taken["rotations"] == 64 * 18
    assert 0 < taken["root = |tau|"] < taken["rotations"]
    assert 0 < taken["c = 1"] < taken["rotations"]


@pytest.mark.parametrize("scale", [2.0 ** -40, 2.0 ** 12, 2.0 ** 40])
def test_sqrt_of_a_rounded_square_is_the_magnitude(scale):
    """givens()' root shortcut: sqrt_rn(RN(x^2)) == |x| for every float32
    mantissa in two binades (both exponent parities) at three scales."""
    m = np.arange(2 ** 23, dtype=np.uint32)
    for lo in (1.0, 2.0):
        x = (np.float32(lo).view(np.uint32) + m).view(F32) * F32(scale)
        root = np.sqrt((x * x).astype(np.float64)).astype(F32)
        np.testing.assert_array_equal(root, x)


@pytest.mark.parametrize("mode", ["all", "trim", "mask", "count",
                                  "dynamic_trim", "enabled"])
def test_icp_walk_equals_icp_run_plain(mode):
    data, model, R0, t0, kw, enabled = _icp_case(mode)
    want = ticp.icp_run_plain(torch.from_numpy(data), torch.from_numpy(model),
                              torch.from_numpy(R0), torch.from_numpy(t0),
                              **_torch_kw(kw, enabled))
    got = np_icp_run(data, model, R0, t0, enabled=enabled, **kw)
    _assert_same(got, want)
    iters = want.iters.tolist()
    live = [i for k, i in enumerate(iters) if enabled is None or enabled[k]]
    assert len(set(live)) > 1, f"rows stop at different iterations: {iters}"
    if mode == "enabled":
        assert iters[1] == 0 and float(want.err[1]) == -1.0


@pytest.mark.parametrize("max_iter", [0, 1])
@pytest.mark.parametrize("mode", ["all", "dynamic_trim"])
def test_icp_walk_equals_icp_run_plain_at_max_iter(mode, max_iter):
    data, model, R0, t0, kw, enabled = _icp_case(mode, K=2, seed=6)
    kw["max_iter"] = max_iter
    want = ticp.icp_run_plain(torch.from_numpy(data), torch.from_numpy(model),
                              torch.from_numpy(R0), torch.from_numpy(t0),
                              **_torch_kw(kw, enabled))
    _assert_same(np_icp_run(data, model, R0, t0, enabled=enabled, **kw),
                 want)
    assert want.iters.tolist() == [max_iter] * 2
    if max_iter == 0:
        assert torch.equal(want.R, torch.from_numpy(R0))
        assert (want.err == -1).all() and (want.nn_idx == 0).all()


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_icp_run_takes_the_plain_loop_on_cpu_tensors():
    data, model, R0, t0, kw, enabled = _icp_case("dynamic_trim", K=2)
    args = [torch.from_numpy(x) for x in (data, model, R0, t0)]
    before = (ticp.icp_run.launches, ticp.kabsch3.launches)
    _assert_same(ticp.icp_run(*args, **_torch_kw(kw, enabled)),
                 ticp.icp_run_plain(*args, **_torch_kw(kw, enabled)))
    ticp.kabsch3(torch.from_numpy(_kabsch_H("random")))
    assert (ticp.icp_run.launches, ticp.kabsch3.launches) == before


def test_icp_run_refuses_other_devices_mixes_and_missing_counts():
    data, model, R0, t0, kw, _ = _icp_case("all", K=1)
    cpu = [torch.from_numpy(x) for x in (data, model, R0, t0)]
    meta = [x.to("meta") for x in cpu]
    with pytest.raises(ValueError):
        ticp.icp_run(*meta, **kw)
    with pytest.raises(ValueError):
        ticp.icp_run(cpu[0], meta[1], *cpu[2:], **kw)
    with pytest.raises(ValueError):
        ticp.icp_run(*cpu, **kw, data_mask=torch.ones(len(data), device="meta"))
    with pytest.raises(ValueError):
        ticp.kabsch3(torch.zeros(3, 3, device="meta"))
    with pytest.raises(ValueError):
        ticp.icp_run(*cpu, **kw, dynamic_trim=True)
    with pytest.raises(ValueError):
        ticp.icp_run(*cpu, **kw, count=torch.tensor(5.0))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 44, 4), (165, 306, 4),
                                   (306, 306, 4), (40, 44, 1),
                                   (165, 306, 8)])
@pytest.mark.parametrize("mode", ["all", "trim", "mask", "count",
                                  "dynamic_trim", "enabled"])
def test_icp_kernel_equals_the_plain_loop_on_card(mode, shape):
    """Data and model points (Nd, M) and rows K: the tests' small clouds,
    the bench's smallest and largest (a cluster of 6 and of 8 blocks a
    row, neither dividing Nd), one row (the fused stream's) and the 8
    initial seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ICP kernel has no CPU mode")
    n, m, K = shape
    if mode == "enabled" and K < 2:
        K = 2
    data, model, R0, t0, kw, enabled = _icp_case(mode, K=K, n=n, m=m)
    if enabled is not None:
        enabled = np.arange(K) % 4 != 1
    args = [torch.from_numpy(x).cuda() for x in (data, model, R0, t0)]
    tkw = _torch_kw(kw, enabled, "cuda")
    before = ticp.icp_run.launches
    got = ticp.icp_run(*args, **tkw)
    assert ticp.icp_run.launches == before + 1
    _assert_same(got, ticp.icp_run_plain(*args, **tkw))
    _assert_same(got, ticp.icp_run_plain(
        *(x.cpu() for x in args), **_torch_kw(kw, enabled)))


@pytest.mark.cuda
def test_kabsch3_kernel_equals_kabsch_from_H_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Kabsch kernel has no CPU mode")
    H = torch.from_numpy(np.stack([_kabsch_H(k) for k in (
        "random", "zero", "rank1", "rank2", "reflection")])).cuda()
    np.testing.assert_array_equal(bits(ticp.kabsch3(H).cpu().numpy()),
                                  bits(ticp.kabsch_from_H(H).cpu().numpy()))
