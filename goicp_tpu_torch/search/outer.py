"""Outer rotation BnB: the host-streaming engine.

Port of goicp_tpu/search/outer.py.  Reference: GoICP::OuterBnB
(jly_goicp.cpp:582-876), a best-first priority queue over rotation
subcubes; per popped cube: Rodrigues, rotate the cloud, InnerBnB twice (ub
with zero rotation uncertainty, lb with maxRotDis), ICP on improvement,
prune the queue.

The host keeps the rotation frontier (the native batched heap,
native/frontier.cpp) and pops `rot_batch` cubes at once; their 8-fold
expansions become L = 8*rot_batch lanes whose bounds one `step_bounds` call
computes on the pair's device (rotate all lanes, the lane-batched inner
BnB), read back to the host in one copy.  Improvements are then adopted in
ascending-ub order with ICP refinement between adoptions: the batched
equivalent of the reference's sequential adopt-then-ICP
(jly_goicp.cpp:771-854) with the same epsilon-optimality.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import os
import time

import numpy as np
import torch

from goicp_tpu_torch.bounds.error import initial_error, refine_transform
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.geom.rotation import rodrigues
from goicp_tpu_torch.native import NativeFrontier
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.search.inner import inner_bnb
from goicp_tpu_torch.utils.fp32 import rotate
from goicp_tpu_torch.utils.npz import savez_exact

SQRT3 = math.sqrt(3.0)


class PyFrontier:
    """The batched heap in Python (heapq keyed (lb, push order)): the
    oracle the native heap is tested against."""

    def __init__(self, capacity: int = 0):
        self._heap: list = []
        self._seq = 0
        self._capacity = capacity
        self.min_dropped_lb = math.inf

    def __len__(self):
        return len(self._heap)

    @property
    def min_lb(self) -> float:
        return self._heap[0][0] if self._heap else math.inf

    def push(self, lb, a, b, c, w, level, ub):
        for i in range(len(lb)):
            heapq.heappush(self._heap,
                           (float(lb[i]), self._seq,
                            (float(a[i]), float(b[i]), float(c[i]),
                             float(w[i]), int(level[i]), float(ub[i]))))
            self._seq += 1
        if self._capacity and len(self._heap) > self._capacity:
            # keep the capacity lowest-lb nodes, fold the best dropped lb
            # into the gap
            keep = heapq.nsmallest(self._capacity, self._heap)
            kept_max = keep[-1]
            self.min_dropped_lb = min(
                self.min_dropped_lb,
                min((e[0] for e in self._heap if e > kept_max),
                    default=math.inf))
            self._heap = keep
            heapq.heapify(self._heap)

    def pop(self, max_n: int, opt_err: float):
        out = [[] for _ in range(7)]
        while self._heap and len(out[0]) < max_n:
            lb, _, (a, b, c, w, level, ub) = heapq.heappop(self._heap)
            if lb >= opt_err:
                continue
            for slot, v in zip(out, (lb, a, b, c, w, level, ub)):
                slot.append(v)
        lbs, a, b, c, w, level, ub = out
        return (np.asarray(lbs, np.float32), np.asarray(a, np.float32),
                np.asarray(b, np.float32), np.asarray(c, np.float32),
                np.asarray(w, np.float32), np.asarray(level, np.int32),
                np.asarray(ub, np.float32))

    def clear(self):
        self._heap.clear()


def frontier_drain(frontier):
    """Pop every node (for checkpointing) and push them back. Returns the
    tuple of node arrays."""
    nodes = frontier.pop(max(len(frontier), 1), np.inf)
    frontier.push(*nodes)
    return nodes


def save_checkpoint(path: str, frontier, opt_state: dict) -> None:
    """Serialize the search state (frontier + incumbent) to exactly `path`
    (with or without `.npz`), so a stopped registration resumes instead of
    restarting."""
    lbs, a, b, c, w, level, ub = frontier_drain(frontier)
    savez_exact(path, dict(lbs=lbs, a=a, b=b, c=c, w=w, level=level, ub=ub,
                           **{f"opt_{k}": v for k, v in opt_state.items()}))


def load_checkpoint(path: str):
    with np.load(path) as z:
        nodes = (z["lbs"], z["a"], z["b"], z["c"], z["w"], z["level"],
                 z["ub"])
        opt = {k[4:]: z[k] for k in z.files if k.startswith("opt_")}
    return nodes, opt


def make_frontier(capacity: int) -> NativeFrontier:
    """The native batched heap (built at first use; a failed build
    raises)."""
    return NativeFrontier(capacity)


@dataclasses.dataclass
class RegistrationResult:
    error: float
    R: np.ndarray           # (3,3) f64
    t: np.ndarray           # (3,) f64
    optComp: int            # incompatibility count of the optimum
    compatibilities: int    # Nd - optComp (the reference's output line)
    geom_error: float
    incomp_error: float
    fpfh_error: float
    last_icp: bool
    time_s: float
    outer_steps: int
    bound_evals: int
    icp_runs: int
    gap: float              # optError - min remaining lb (<= SSEThresh)
    converged: bool


def to_host(*tensors) -> list:
    """Several device tensors -> numpy arrays of their own dtypes, in ONE
    device-to-host copy (every value is exact in float64: float32, int32,
    bool, and int64 counters below 2**53)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(host[off:off + n].reshape(tuple(t.shape)).astype(dtype))
        off += n
    return out


def _rotate_lanes(data: torch.Tensor, centers: torch.Tensor):
    R = rodrigues(centers)                              # (L,3,3)
    return R, rotate(R, data)


def step_bounds(pair: PairData, cfg: GoICPConfig, centers: torch.Tensor,
                widths: torch.Tensor, active: torch.Tensor,
                opt_error: torch.Tensor):
    """One outer step's device work: rotate all lanes, then the inner ub
    pass and the inner lb pass seeded with the in-step incumbent
    min(opt_error, best ub found), or, with cfg.fused_inner, one fused
    search that yields both.  The best ub is an ACHIEVED error (a
    translation node's ub is the exact error at its center,
    jly_goicp.cpp:331-401 with zero uncertainty), so seeding the lb pass
    with it is valid.  Returns (R_lanes, res_ub, res_lb)."""
    R, pts = _rotate_lanes(pair.data, centers)
    if cfg.fused_inner:
        res_ub = inner_bnb(pair, cfg, pts, widths, active, opt_error,
                           with_rot_uncertainty=False, fused=True)
        return R, res_ub, res_ub
    res_ub = inner_bnb(pair, cfg, pts, widths, active, opt_error,
                       with_rot_uncertainty=False)
    incumbent = torch.minimum(
        opt_error, torch.amin(torch.where(active, res_ub.best_err,
                                          torch.inf)))
    res_lb = inner_bnb(pair, cfg, pts, widths, active, incumbent,
                       with_rot_uncertainty=True)
    return R, res_ub, res_lb


def _refine(pair: PairData, cfg: GoICPConfig, R, t, with_bnb_count=True):
    """refine_transform from (R, t), read back in one copy: (bnb_count, R,
    t, error, geom, incomp + nbr term, fpfh term, icp_incomp)."""
    dev = pair.device
    bnb, res, sc, inc = refine_transform(
        pair, cfg, torch.as_tensor(R, dtype=torch.float32, device=dev),
        torch.as_tensor(t, dtype=torch.float32, device=dev),
        max_iter=cfg.icp_max_iter, with_bnb_count=with_bnb_count)
    return to_host(bnb, res.R[0], res.t[0], sc.error[0], sc.geom[0],
                   sc.incomp_term[0] + sc.nbr_term[0], sc.fpfh_term[0],
                   inc[0])


def register(pair: PairData, cfg: GoICPConfig, verbose: bool = False,
             checkpoint_path: str | None = None,
             checkpoint_every: int = 100) -> RegistrationResult:
    """Full Go-ICP global registration of pair.data onto pair.model, on
    the pair's device.

    checkpoint_path: if given, the search state (frontier + incumbent) is
    saved every `checkpoint_every` outer steps and restored on restart."""
    if pair.dynamic_counts:
        raise ValueError("the host engine needs static counts; "
                         "dynamic_counts pairs are for the device engines")
    t0 = time.time()
    log = print if verbose else (lambda *a, **k: None)
    dev = pair.device
    sse_thresh = cfg.mse_margin * pair.inlier_num
    nd = pair.n_data

    # ---- initial incumbent at identity + worst-case chem seeds, and the
    # initial ICP from identity (jly_goicp.cpp:597-661), read together ----
    opt_R = np.eye(3)
    opt_t = np.zeros(3)
    opt_comp = 0
    incomp_err = 0.0
    fpfh_err = 0.0
    last_icp = False
    icp_runs = 1
    (init_err,) = to_host(initial_error(pair, cfg))
    _, icp_R, icp_t, icp_err, icp_geom, icp_ic, icp_fp, icp_inc = _refine(
        pair, cfg, np.eye(3), np.zeros(3), with_bnb_count=False)
    opt_error = float(init_err)
    if np.isnan(opt_error) or np.isnan(float(icp_err)):
        # numeric guard: fail loudly, never search on NaN
        raise FloatingPointError("NaN in initial error/ICP scoring")
    geom_err = opt_error
    log(f"Error*: {opt_error:.6g} (Init)")
    if float(icp_err) < opt_error:
        opt_error = float(icp_err)
        opt_R = np.asarray(icp_R, np.float64)
        opt_t = np.asarray(icp_t, np.float64)
        opt_comp = int(icp_inc)
        geom_err = float(icp_geom)
        incomp_err = float(icp_ic)
        fpfh_err = float(icp_fp)
        last_icp = True
        log(f"Error*: {opt_error:.6g} (ICP init), comp {nd - opt_comp}")

    # ---- rotation frontier (the native batched min-heap) ----
    frontier = make_frontier(cfg.rot_frontier_capacity)
    frontier.push(np.zeros(1, np.float32),
                  np.asarray([cfg.rotMinX], np.float32),
                  np.asarray([cfg.rotMinY], np.float32),
                  np.asarray([cfg.rotMinZ], np.float32),
                  np.asarray([cfg.rotWidth], np.float32),
                  np.zeros(1, np.int32), np.full(1, np.inf, np.float32))

    L = cfg.rot_batch * 8
    outer_steps = 0
    bound_evals = 0
    converged = False
    min_lb_seen = 0.0

    if checkpoint_path and os.path.exists(checkpoint_path):
        nodes, opt_state = load_checkpoint(checkpoint_path)
        if float(opt_state["error"]) < opt_error:
            opt_error = float(opt_state["error"])
            opt_R = opt_state["R"]
            opt_t = opt_state["t"]
            opt_comp = int(opt_state["comp"])
            last_icp = bool(opt_state["last_icp"])
        frontier.clear()
        frontier.push(*nodes)
        outer_steps = int(opt_state["steps"])
        log(f"resumed from {checkpoint_path}: step {outer_steps}, "
            f"error {opt_error:.6g}, frontier {len(frontier)}")

    off = np.array([[j & 1, (j >> 1) & 1, (j >> 2) & 1]
                    for j in range(8)], np.float32)              # (8,3)
    while len(frontier) and outer_steps < cfg.max_outer_steps:
        if (checkpoint_path and outer_steps
                and outer_steps % checkpoint_every == 0):
            save_checkpoint(checkpoint_path, frontier,
                            dict(error=opt_error, R=opt_R, t=opt_t,
                                 comp=opt_comp, last_icp=last_icp,
                                 steps=outer_steps))
        # ---- pop a batch of rotation cubes ----
        p_lb, p_a, p_b, p_c, p_w, p_level, _ = frontier.pop(
            cfg.rot_batch, opt_error)
        if len(p_lb) == 0:
            converged = True  # every remaining node was stale
            break
        if opt_error - p_lb[0] <= sse_thresh:
            # min-lb node within threshold -> all remaining are too
            frontier.clear()
            converged = True
            min_lb_seen = float(p_lb[0])
            break
        # drop popped nodes that individually hit the threshold
        keep = opt_error - p_lb > sse_thresh
        p_lb, p_a, p_b, p_c, p_w, p_level = (
            x[keep] for x in (p_lb, p_a, p_b, p_c, p_w, p_level))
        outer_steps += 1
        min_lb_seen = float(p_lb[0])

        # ---- expand 8 children per parent, pi-ball filter ----
        n_par = len(p_lb)
        cw = (p_w / 2.0)[:, None]                               # (P,1)
        child_xyz = np.stack([p_a, p_b, p_c], 1)[:, None, :] \
            + off[None] * cw[..., None]                         # (P,8,3)
        child_ctr = child_xyz + cw[..., None] / 2.0             # (P,8,3)
        n_child = n_par * 8
        centers = np.zeros((L, 3), np.float32)
        widths = np.zeros((L,), np.float32)
        active = np.zeros((L,), bool)
        child_nodes = np.zeros((L, 5), np.float64)  # a,b,c,w,level
        centers[:n_child] = child_ctr.reshape(-1, 3)
        widths[:n_child] = np.repeat(p_w / 2.0, 8)
        child_nodes[:n_child, 0:3] = child_xyz.reshape(-1, 3)
        child_nodes[:n_child, 3] = np.repeat(p_w / 2.0, 8)
        child_nodes[:n_child, 4] = np.repeat(p_level + 1, 8)
        inside = (np.linalg.norm(centers[:n_child], axis=1)
                  - SQRT3 * widths[:n_child] / 2.0) <= math.pi
        active[:n_child] = inside  # pi-ball skip (jly_goicp.cpp:723-726)
        centers[:n_child][~inside] = 0.0
        widths[:n_child][~inside] = 0.0

        # ---- the step's bound work on the device, read back in ONE copy
        R_lanes, res_ub, res_lb = step_bounds(
            pair, cfg, torch.as_tensor(centers, device=dev),
            torch.as_tensor(widths, device=dev),
            torch.as_tensor(active, device=dev),
            torch.tensor(opt_error, dtype=torch.float32, device=dev))
        (R_lanes_np, ubs, best_nodes, ub_terms, ub_evals, lbs,
         lb_evals) = to_host(R_lanes, res_ub.best_err, res_ub.best_node,
                             res_ub.ub_terms, res_ub.evals, res_lb.lb_safe,
                             res_lb.evals)
        bound_evals += int(ub_evals) + \
            (0 if cfg.fused_inner else int(lb_evals))
        ubs = np.asarray(ubs, np.float64)
        ubs[~active] = np.inf
        lbs = np.asarray(lbs, np.float64)
        R_lanes_np = np.asarray(R_lanes_np, np.float64)

        # ---- adopt improvements in ascending-ub order, ICP after each
        # (jly_goicp.cpp:771-854) ----
        for lane in np.argsort(ubs):
            if ubs[lane] >= opt_error:
                break
            opt_error = float(ubs[lane])
            opt_R = R_lanes_np[lane]
            tn = best_nodes[lane]
            opt_t = tn[:3] + tn[3] / 2.0
            geom_err, ic, fp = np.asarray(ub_terms[lane], np.float64)
            incomp_err, fpfh_err = float(ic), float(fp)
            last_icp = False
            icp_runs += 1
            (bnb_comp, icp_R, icp_t, icp_err, icp_geom, icp_ic, icp_fp,
             icp_inc) = _refine(pair, cfg, opt_R, opt_t)
            opt_comp = int(bnb_comp)
            log(f"Error*: {opt_error:.6g} (BNB), comp {nd - opt_comp}")
            if float(icp_err) < opt_error:
                opt_error = float(icp_err)
                opt_R = np.asarray(icp_R, np.float64)
                opt_t = np.asarray(icp_t, np.float64)
                opt_comp = int(icp_inc)
                geom_err = float(icp_geom)
                incomp_err = float(icp_ic)
                fpfh_err = float(icp_fp)
                last_icp = True
                log(f"Error*: {opt_error:.6g} (ICP), comp {nd - opt_comp}")

        # ---- push surviving children (capacity drops are folded into the
        # reported gap via min_dropped_lb) ----
        survive = active & (lbs < opt_error)
        if survive.any():
            frontier.push(lbs[survive].astype(np.float32),
                          child_nodes[survive, 0].astype(np.float32),
                          child_nodes[survive, 1].astype(np.float32),
                          child_nodes[survive, 2].astype(np.float32),
                          child_nodes[survive, 3].astype(np.float32),
                          child_nodes[survive, 4].astype(np.int32),
                          ubs[survive].astype(np.float32))

    if checkpoint_path and os.path.exists(checkpoint_path) and \
            (converged or not len(frontier)):
        os.unlink(checkpoint_path)  # finished: checkpoint no longer needed
    if not len(frontier) and not converged:
        converged = True  # frontier exhausted ("Rotation Queue Empty")
    remaining_lb = frontier.min_lb if len(frontier) else opt_error
    remaining_lb = min(remaining_lb, frontier.min_dropped_lb)
    gap = max(0.0, opt_error - min(remaining_lb, opt_error)) \
        if len(frontier) else max(0.0, min(opt_error - min_lb_seen,
                                           sse_thresh))
    return RegistrationResult(
        error=opt_error, R=opt_R, t=opt_t, optComp=opt_comp,
        compatibilities=nd - opt_comp, geom_error=geom_err,
        incomp_error=incomp_err, fpfh_error=fpfh_err, last_icp=last_icp,
        time_s=time.time() - t0, outer_steps=outer_steps,
        bound_evals=bound_evals, icp_runs=icp_runs, gap=gap,
        converged=converged)
