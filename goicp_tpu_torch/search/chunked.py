"""Chunked batched registration: convergence compaction + checkpoint/resume.

Port of goicp_tpu/search/chunked.py.  A batch run to convergence
(device_engine.register_device_batch) carries every converged row along
until the slowest pair converges.  Here the batch advances in chunks of
outer iterations; between chunks the host reads ONLY the convergence flags
and the outer-step counts, retires the finished rows, and compacts the
survivors into the next power-of-two width (64 -> 32 -> ... -> 1), so the
tail of a hard pair runs at width 1.

The carried state is the explicit batch state of search/device_engine.py
(batch_init / batch_run_chunk / device_finalize), so a chunk boundary is
also a checkpoint: save_state / load_state write and read the mid-search
state of every row in flight, and a killed run resumes to the identical
optimum (the search is deterministic).  The reference has no checkpoints;
its closest analogue is per-pair idempotent output files
(bo1_GoICP.py:49-51).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.dist.mesh import stack_pairs
from goicp_tpu_torch.search.device_engine import (DeviceResult,
                                                  batch_init,
                                                  batch_run_chunk,
                                                  device_finalize,
                                                  result_to_numpy)
from goicp_tpu_torch.search.fused_stream import StreamStopped, _take_pairs
from goicp_tpu_torch.utils.npz import savez_exact

# what the compacting runner did since reset_counters(): the batch width
# of each chunk it ran
counters = dict(widths=[])


def reset_counters():
    counters["widths"] = []


def _next_bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _take(state: dict, idx) -> dict:
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                          device=state["converged"].device)
    return {k: v[idx] for k, v in state.items()}


def _row_result(res: DeviceResult, row: int) -> DeviceResult:
    return DeviceResult(*(v[row] for v in res))


def save_state(path: str, state: dict, active_idx, done: dict) -> None:
    """Write an in-flight batch to exactly `path`: the per-row search
    state, the original pair of each row (active_idx) and the results
    retired so far, by original pair."""
    blob = {f"state_{k}": np.asarray(v.cpu()) for k, v in state.items()}
    blob["active_idx"] = np.asarray(active_idx, np.int64)
    blob["done_idx"] = np.asarray(sorted(done.keys()), np.int64)
    for f in DeviceResult._fields:
        blob[f"done_{f}"] = np.stack(
            [np.asarray(getattr(done[i], f)) for i in sorted(done.keys())]) \
            if done else np.zeros((0,))
    savez_exact(path, blob)


def load_state(path: str, device=None):
    """-> (state on `device`, active_idx, done {original pair:
    DeviceResult}); device None means goicp_tpu_torch.default_device()."""
    if device is None:
        from goicp_tpu_torch import default_device
        device = default_device()
    with np.load(path) as z:
        state = {k[len("state_"):]: torch.as_tensor(np.array(z[k]),
                                                    device=device)
                 for k in z.files if k.startswith("state_")}
        active_idx = z["active_idx"]
        done = {}
        for j, i in enumerate(z["done_idx"]):
            done[int(i)] = DeviceResult(
                *(z[f"done_{f}"][j] for f in DeviceResult._fields))
    return state, active_idx, done


def register_device_batch_compact(pairs, cfg: GoICPConfig,
                                  chunk_steps: int = 256, mesh=None,
                                  checkpoint_path: str | None = None,
                                  resume: bool = False,
                                  max_chunks: int | None = None,
                                  pad_to: int | None = None):
    """Register a same-bucket batch of pairs (all on one device) with
    convergence compaction.

    Returns a DeviceResult of numpy arrays with a leading pair axis in the
    order of `pairs`.  checkpoint_path: save the in-flight state after
    every chunk; resume=True restarts from that file (same pairs, cfg).
    max_chunks bounds the chunks run: when it is reached, the state is
    saved and StreamStopped (a RuntimeError) raised.  pad_to: round the
    batch up by repeating pair 0, the pad rows' state pre-converged, so
    that they never search and retire at the first compaction.  mesh:
    every rank of it calls this with the same pairs; the pair axis splits
    over `data` (dist/mesh.map_pair_blocks), each data rank compacting
    its own block, and every rank returns the whole batch.  With a mesh pad_to is not
    needed (the blocks are padded the same way) and each rank checkpoints
    its block to a file of its own (dist/mesh.rank_path)."""
    pairs = list(pairs)
    if mesh is not None:
        from goicp_tpu_torch.dist.mesh import map_pair_blocks, rank_path
        path = checkpoint_path and rank_path(checkpoint_path)
        return map_pair_blocks(mesh, pairs, lambda block, n_live: _compact(
            block, n_live, cfg, chunk_steps, path, resume, max_chunks))
    B = len(pairs)
    n_pad = max(0, (pad_to or B) - B)
    out = _compact(pairs + [pairs[0]] * n_pad, B, cfg, chunk_steps,
                   checkpoint_path, resume, max_chunks)
    return DeviceResult(*(v[:B] for v in out))


def _compact(pairs: list, n_live: int, cfg: GoICPConfig, chunk_steps: int,
             checkpoint_path, resume: bool, max_chunks) -> DeviceResult:
    """The compacting runner over every row of `pairs`, the rows from
    n_live on pre-converged; returns every row's result."""
    stacked_all = stack_pairs(pairs)

    done: dict[int, DeviceResult] = {}
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state, active_idx, done = load_state(checkpoint_path,
                                             stacked_all.device)
        cur_pair = _take_pairs(stacked_all, active_idx)
    else:
        active_idx = np.arange(len(pairs))
        cur_pair = stacked_all
        state = batch_init(cur_pair, cfg)
        state["converged"][n_live:] = True

    # geometric chunk schedule: early chunks are short, so that pairs that
    # converge quickly retire (and the batch compacts) before long chunks
    def _sched(i: int) -> int:
        return min(chunk_steps, 16 * (4 ** i))

    chunks = 0
    while True:
        counters["widths"].append(len(active_idx))
        state = batch_run_chunk(cur_pair, cfg, state, _sched(chunks))
        chunks += 1
        flags = torch.stack([state["converged"].to(torch.int64),
                             state["it"].to(torch.int64)]).cpu().numpy()
        finished = (flags[0] > 0) | (flags[1] >= cfg.max_outer_steps)

        if finished.all():
            res = result_to_numpy(device_finalize(state))
            for row, orig in enumerate(active_idx):
                if int(orig) not in done:
                    done[int(orig)] = _row_result(res, row)
            break

        n_act = int((~finished).sum())
        bucket = _next_bucket(n_act)
        if bucket < len(active_idx):
            # retire the finished rows, compact the survivors into the
            # next power of two, padded with the first survivor (its
            # search is deterministic, so its duplicate is harmless)
            res = result_to_numpy(device_finalize(state))
            for row, orig in enumerate(active_idx):
                if finished[row]:
                    done[int(orig)] = _row_result(res, row)
            rows = np.where(~finished)[0]
            take = np.concatenate([rows, np.repeat(rows[:1], bucket - n_act)])
            cur_pair = _take_pairs(cur_pair, take)
            state = _take(state, take)
            active_idx = active_idx[take]

        hit_cap = max_chunks is not None and chunks >= max_chunks
        if checkpoint_path:
            save_state(checkpoint_path, state, active_idx, done)
        if hit_cap:
            raise StreamStopped(
                f"max_chunks={max_chunks} reached with {n_act} pairs in "
                f"flight (state checkpointed)")

    rows = [done[i] for i in range(len(pairs))]
    return DeviceResult(*(np.stack([np.asarray(getattr(r, f)) for r in rows])
                          for f in DeviceResult._fields))


def register_device_stream(pairs, cfg: GoICPConfig, width: int = 8,
                           chunk_steps: int = 32):
    """The lockstep stream's entry point, kept as a thin adapter over the
    cross-pair fused stream (search/fused_stream.register_fused_stream):
    the same window/refill contract, per-pair results equal to
    register_device.  Returns a DeviceResult of numpy arrays in the order
    of `pairs`."""
    from goicp_tpu_torch.search.fused_stream import register_fused_stream
    return register_fused_stream(pairs, cfg, width=width,
                                 chunk_steps=max(chunk_steps, 64))
