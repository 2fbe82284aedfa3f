"""Batched trimmed ICP with Kabsch/SVD updates.

Port of goicp_tpu/icp/icp.py.  Reference: ICP3D<T>::Run
(jly_icp3d.hpp:197-311) — 1-NN correspondences, optional trim (keep
n*(1-trimFraction) closest pairs), Kabsch via SVD with det correction,
compose, iterate until err - err_new < err_diff * num or max_iter.

The NN search is a brute-force squared-distance matrix
(|x|^2 - 2 x.y + |y|^2, first-index argmin); the 3x3 SVD is the
closed-form one-sided Jacobi of the JAX package, its square roots
correctly rounded on every device (grid/edt.py::exact_sqrt), as XLA's.
Every sum and product takes the fixed order of utils/fp32.py, so the
card and the CPU give the same bits: the sums over the points and the
3x3 products of the loop K1/K3's order, the Kabsch (kabsch_from_H) the
orders that XLA:CPU takes op by op (sequential sums; its last product an
FMA chain, fp32.dot_fma), in which it equals the JAX package's
kabsch_from_H run op by op bit for bit.
icp_run runs K starts at once (the JAX package vmaps it).  On CUDA
tensors it is one launch of csrc/icp.cu (goicp_icp_run): a thread-block
cluster per row (its blocks splitting the nearest-neighbour scan) loops
that row's iterations on the card, no host read, counted in
`icp_run.launches`.  On CPU tensors it is icp_run_plain, a Python loop
that steps every row while any row is still running (rows that have
stopped keep their state, as rows of a vmapped while_loop do); any other
device, or a mix, raises.  The kernel takes the plain loop's orders step
by step, so the two give the same bits; on card tensors the plain loop
is the kernel's yardstick (its sums then launch the kernels of
utils/fp32.py).  kabsch3 is the kernel's Kabsch alone (goicp_kabsch3),
kabsch_from_H's twin on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from goicp_tpu_torch.grid.edt import exact_sqrt
from goicp_tpu_torch.utils.fp32 import (_check_f32, _launch, _on_cpu,
                                        _ptr, _stream, cross3, det3, dot3,
                                        dot_fma, kernels, matmul3, matvec3,
                                        ordered_sum, rotate, sq_dist3)

SEQ = 1    # ordered_sum's sequential order (lanes=1), the Kabsch's
# csrc/icp.cu: a row's one-block workspace (10 Nd + 4 M floats) in shared
# memory at most this many bytes (kIcpSmemMax), else in device memory
ICP_SMEM_BYTES = 227 * 1024 - 1024
# csrc/icp.cu's masks: untrimmed, static trim, data_mask, dynamic trim
MODE_ALL, MODE_TRIM, MODE_COUNT, MODE_DYN_TRIM = range(4)


class ICPResult(NamedTuple):
    R: torch.Tensor          # (K, 3, 3)
    t: torch.Tensor          # (K, 3)
    nn_idx: torch.Tensor     # (K, Nd) final model correspondence per point
    err: torch.Tensor        # (K,) final kept-pair squared-distance sum
    iters: torch.Tensor      # (K,) iterations each row ran


def nn_correspondences(points: torch.Tensor, model: torch.Tensor):
    """points (..., N, 3) x model (M, 3) -> (nn_idx (..., N) i64,
    sq_dist (..., N)).  Exact 1-NN via the expanded distance matrix."""
    d2 = sq_dist3(points, model)
    idx = torch.argmin(d2, dim=-1)
    best = torch.gather(d2, -1, idx[..., None])[..., 0]
    return idx, torch.clamp(best, min=0.0)


def _set_cols(M: torch.Tensor, cols: dict) -> torch.Tensor:
    out = M.clone()
    for j, c in cols.items():
        out[..., :, j] = c
    return out


def _jacobi_svd3(H: torch.Tensor, sweeps: int = 6):
    """One-sided Jacobi SVD of a (..., 3, 3) matrix: H = U diag(sigma) V^T
    with V a proper rotation (product of Givens rotations), sigma >= 0
    sorted descending, U's columns orthonormal (degenerate columns completed
    by cross products)."""
    A = H
    V = torch.eye(3, dtype=H.dtype, device=H.device).expand(H.shape)

    def rot(A, V, p, q):
        ap, aq = A[..., :, p], A[..., :, q]
        app = dot3(ap, ap, SEQ)
        aqq = dot3(aq, aq, SEQ)
        apq = dot3(ap, aq, SEQ)
        # Givens rotation zeroing the (p,q) column inner product
        safe = torch.abs(apq) > 1e-30
        tau = (aqq - app) / torch.where(safe, 2.0 * apq,
                                        torch.ones_like(apq))
        t = torch.where(
            safe,
            torch.sign(tau) / (torch.abs(tau) + exact_sqrt(1.0 + tau * tau)),
            torch.zeros_like(tau))
        c = 1.0 / exact_sqrt(1.0 + t * t)
        s = t * c

        def apply(M):
            mp, mq = M[..., :, p], M[..., :, q]
            np_ = c[..., None] * mp - s[..., None] * mq
            nq_ = s[..., None] * mp + c[..., None] * mq
            return _set_cols(M, {p: np_, q: nq_})

        return apply(A), apply(V)

    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            A, V = rot(A, V, p, q)
    sigma = exact_sqrt(ordered_sum(A * A, -2, SEQ))      # (..., 3)
    # sort columns by sigma DESCENDING (compare-swap network, applied
    # jointly to A, V and sigma)
    for p, q in ((0, 1), (0, 2), (1, 2)):
        swap = sigma[..., p] < sigma[..., q]
        sw = swap[..., None]

        def csw(M):
            mp, mq = M[..., :, p], M[..., :, q]
            return _set_cols(M, {p: torch.where(sw, mq, mp),
                                 q: torch.where(sw, mp, mq)})

        A = csw(A)
        V = csw(V)
        sp, sq = sigma[..., p], sigma[..., q]
        sigma = sigma.clone()
        sigma[..., p] = torch.where(swap, sq, sp)
        sigma[..., q] = torch.where(swap, sp, sq)
    s1 = torch.amax(sigma, dim=-1, keepdim=True)
    ok = sigma > 1e-5 * torch.clamp(s1, min=1e-30)
    U = A / torch.clamp(sigma, min=1e-30)[..., None, :]
    u0, u1, u2 = U[..., :, 0], U[..., :, 1], U[..., :, 2]
    # branch-free orthonormal completion of degenerate columns
    e = (torch.argmin(torch.abs(u0), dim=-1)[..., None]
         == torch.arange(3, device=H.device)).to(u0.dtype)
    alt1 = cross3(u0, e)
    alt1 = alt1 / torch.clamp(exact_sqrt(dot3(alt1, alt1, SEQ)),
                              min=1e-30)[..., None]
    u1 = torch.where(ok[..., 1:2], u1, alt1)
    u2 = torch.where(ok[..., 2:3], u2, cross3(u0, u1))
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, sigma, V


def kabsch(q_d: torch.Tensor, q_m: torch.Tensor,
           w: torch.Tensor | None = None) -> torch.Tensor:
    """Best rotation R_ s.t. R_ @ q_d ~ q_m (centered inputs (..., N, 3));
    SVD with det correction.  Optional per-row 0/1 weights."""
    if w is not None:
        q_d = q_d * w[..., None]
    H = ordered_sum(q_d[..., :, :, None] * q_m[..., :, None, :],
                    -3)                                    # (..., 3, 3)
    return kabsch_from_H(H)


def kabsch_from_H(H: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) correspondence matrix -> optimal rotation
    R = V D U^T, D = diag(1,1,det(V U^T)) on the SMALLEST singular
    direction (Kabsch/Umeyama).  H == 0 returns identity."""
    hmax = torch.amax(torch.abs(H), dim=(-2, -1), keepdim=True)
    Hn = H / torch.clamp(hmax, min=1e-30)             # scale-invariant
    U, sigma, V = _jacobi_svd3(Hn)
    det = det3(V) * det3(U)          # det(V U^T), both orthonormal
    small = torch.argmin(sigma, dim=-1)
    d = torch.where(torch.arange(3, device=H.device) == small[..., None],
                    det[..., None], torch.ones_like(sigma))   # (..., 3)
    R = dot_fma(V[..., :, None, :], (d[..., None, :] * U)[..., None, :, :])
    eye = torch.eye(3, dtype=H.dtype, device=H.device).expand(R.shape)
    return torch.where(hmax > 0, R, eye)


def kabsch3(H: torch.Tensor) -> torch.Tensor:
    """kabsch_from_H of (..., 3, 3) float32 H: one launch of csrc/icp.cu's
    goicp_kabsch3 (the ICP kernel's own Kabsch, a thread per matrix) on a
    CUDA tensor, kabsch_from_H on a CPU one."""
    if _on_cpu(H):
        return kabsch_from_H(H)
    _check_f32(H)
    if H.shape[-2:] != (3, 3):
        raise ValueError(f"kabsch3 takes (..., 3, 3), got {tuple(H.shape)}")
    H = H.contiguous()
    out = torch.empty_like(H)
    if out.numel() == 0:
        return out
    _launch(kernels.goicp_kabsch3(H.data_ptr(), out.data_ptr(),
                                  H.numel() // 9, _stream(H)), "kabsch3")
    kabsch3.launches += 1
    return out


kabsch3.launches = 0


def icp_mode(n: int, inlier_num: int, count, data_mask,
             dynamic_trim: bool) -> int:
    """The kept set of an ICP iteration (csrc/icp.cu's mask modes), in
    icp_run_plain's order of precedence: dynamic trim (the `count`
    smallest distances), the data_mask rows (count given), a static trim
    (the inlier_num smallest, inlier_num < n) or every row."""
    if dynamic_trim:
        if count is None:
            raise ValueError("dynamic_trim needs count")
        return MODE_DYN_TRIM
    if count is not None:
        if data_mask is None:
            raise ValueError("count without dynamic_trim keeps the "
                             "data_mask rows: data_mask is needed")
        return MODE_COUNT
    return MODE_TRIM if inlier_num < n else MODE_ALL


def icp_run(data: torch.Tensor, model: torch.Tensor, R0: torch.Tensor,
            t0: torch.Tensor, *, inlier_num: int, max_iter: int,
            err_diff: float, data_mask: torch.Tensor | None = None,
            count: torch.Tensor | None = None,
            dynamic_trim: bool = False,
            enabled: torch.Tensor | None = None) -> ICPResult:
    """Run ICP from K starts (R0 (K,3,3), t0 (K,3)).  inlier_num == Nd
    means no trimming.

    data_mask (shape-bucket padding): padded rows get a huge NN distance so
    no trim selection includes them.  count (dynamic-counts mode): the kept-
    set size as a 0-d tensor — the REAL point count (the kept set is the
    data_mask rows) or, with dynamic_trim, the REAL inlier count (the
    `count` smallest NN distances, by an exact rank mask over a stable
    argsort).  enabled (bool, scalar or (K,)): rows where it is False run
    zero iterations and return (R0, t0, err=-1, nn_idx=0).

    CUDA tensors: one launch of csrc/icp.cu; CPU tensors: icp_run_plain;
    other devices, or a mix of devices, raise."""
    mode = icp_mode(data.shape[0], inlier_num, count, data_mask,
                    dynamic_trim)
    kw = dict(inlier_num=inlier_num, max_iter=max_iter, err_diff=err_diff,
              data_mask=data_mask, count=count, dynamic_trim=dynamic_trim,
              enabled=enabled)
    if _on_cpu(*(x for x in (data, model, R0, t0, data_mask, count)
                 if x is not None)):
        return icp_run_plain(data, model, R0, t0, **kw)
    dev = data.device
    _check_f32(data, model, *(x for x in (data_mask, count)
                              if x is not None))
    data, model = data.contiguous(), model.contiguous()
    R0 = R0.to(torch.float32).contiguous()
    t0 = t0.to(torch.float32).contiguous()
    K, nd, m = R0.shape[0], data.shape[0], model.shape[0]
    if (data.shape != (nd, 3) or model.shape != (m, 3) or nd == 0 or m == 0
            or R0.shape != (K, 3, 3) or t0.shape != (K, 3)
            or (data_mask is not None and data_mask.shape != (nd,))
            or (count is not None and count.numel() != 1)):
        raise ValueError(
            f"icp_run takes data (Nd,3), model (M,3) with Nd, M > 0, R0 "
            f"(K,3,3), t0 (K,3), data_mask (Nd,), a scalar count; got "
            f"{tuple(data.shape)}, {tuple(model.shape)}, {tuple(R0.shape)}, "
            f"{tuple(t0.shape)}, "
            f"{None if data_mask is None else tuple(data_mask.shape)}, "
            f"{None if count is None else tuple(count.shape)}")
    out = ICPResult(
        R=torch.empty((K, 3, 3), dtype=torch.float32, device=dev),
        t=torch.empty((K, 3), dtype=torch.float32, device=dev),
        nn_idx=torch.empty((K, nd), dtype=torch.int64, device=dev),
        err=torch.empty((K,), dtype=torch.float32, device=dev),
        iters=torch.empty((K,), dtype=torch.int32, device=dev))
    if K == 0:
        return out
    en = None if enabled is None else torch.as_tensor(
        enabled, device=dev).to(torch.bool).expand(K).contiguous()
    mask = None if data_mask is None else data_mask.contiguous()
    words = 10 * nd + 4 * m
    ws = None if 4 * words <= ICP_SMEM_BYTES else torch.empty(
        K * words, dtype=torch.float32, device=dev)
    _launch(kernels.goicp_icp_run(
        _ptr(data), _ptr(model), _ptr(R0), _ptr(t0), _ptr(mask), _ptr(count),
        _ptr(en), _ptr(ws), *(_ptr(x) for x in out), K, nd, m,
        int(inlier_num), int(max_iter), mode, float(err_diff),
        _stream(data)), "icp_run")
    icp_run.launches += 1
    return out


icp_run.launches = 0


def icp_run_plain(data: torch.Tensor, model: torch.Tensor, R0: torch.Tensor,
                  t0: torch.Tensor, *, inlier_num: int, max_iter: int,
                  err_diff: float, data_mask: torch.Tensor | None = None,
                  count: torch.Tensor | None = None,
                  dynamic_trim: bool = False,
                  enabled: torch.Tensor | None = None) -> ICPResult:
    """icp_run as a host loop of torch ops (the module docstring): every
    row is stepped while any row is still running, one host read an
    iteration."""
    n = data.shape[0]
    K = R0.shape[0]
    dev = data.device
    trim = count is None and inlier_num < n
    cnt = torch.tensor(float(inlier_num), device=dev) if count is None \
        else count
    ranks = torch.arange(n, device=dev)

    R = R0.to(torch.float32)
    t = t0.to(torch.float32)
    err = torch.full((K,), -1.0, device=dev)
    nn_idx = torch.zeros((K, n), dtype=torch.int64, device=dev)
    it = torch.zeros((K,), dtype=torch.int32, device=dev)
    converged = torch.zeros((K,), dtype=torch.bool, device=dev)
    if enabled is not None:
        converged = converged | ~torch.as_tensor(enabled, device=dev)

    while True:
        running = (~converged) & (it < max_iter)
        if not bool(running.any()):
            break
        pts = rotate(R, data, t)
        idx, d2 = nn_correspondences(pts, model)
        if data_mask is not None:
            d2 = torch.where(data_mask > 0, d2, 1.0e12)
        if dynamic_trim:
            order = torch.argsort(d2, dim=-1, stable=True)  # smallest first
            in_rank = (ranks < count).to(torch.float32).expand(K, n)
            mask = torch.zeros((K, n), device=dev).scatter(1, order, in_rank)
        elif count is not None:
            mask = data_mask.expand(K, n)
        elif trim:
            keep = torch.argsort(d2, dim=-1, stable=True)[:, :inlier_num]
            mask = torch.zeros((K, n), device=dev).scatter(
                1, keep, torch.ones_like(keep, dtype=torch.float32))
        else:
            mask = torch.ones((K, n), device=dev)
        err_new = ordered_sum(d2 * mask)
        conv = (err > 0) & (err - err_new < err_diff * cnt)

        m_corr = model[idx]                                # (K,Nd,3)
        mw = mask[..., None]
        mu_d = ordered_sum(pts * mw, 1) / cnt
        mu_m = ordered_sum(m_corr * mw, 1) / cnt
        R_ = kabsch((pts - mu_d[:, None, :]) * mw,
                    (m_corr - mu_m[:, None, :]) * mw)
        t_ = mu_m - matvec3(R_, mu_d)
        R_next = torch.where(conv[:, None, None], R, matmul3(R_, R))
        t_next = torch.where(conv[:, None], t, matvec3(R_, t) + t_)

        r1 = running[:, None]
        R = torch.where(running[:, None, None], R_next, R)
        t = torch.where(r1, t_next, t)
        err = torch.where(running, err_new, err)
        nn_idx = torch.where(r1, idx, nn_idx)
        it = it + running.to(torch.int32)
        converged = torch.where(running, conv, converged)
    return ICPResult(R=R, t=t, nn_idx=nn_idx, err=err, iters=it)
