"""Batched multi-pair registration: N pairs' searches share the card.

Port of goicp_tpu/pipeline/batch_sweep.py: `register_batch` is a thin
adapter over the cross-pair fused stream (search/fused_stream.py) with the
per-pair contract (list[RegistrationResult] in input order, static
same-bucket pairs, optional pair-level data parallelism over a mesh), so
call sites that registered pairs one by one keep
the one shared adopt/gap implementation.
"""

from __future__ import annotations

import dataclasses
import time

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.search.outer import RegistrationResult


def register_batch(pairs: list[PairData], cfg: GoICPConfig,
                   slots: int | None = None,
                   max_steps: int | None = None,
                   mesh=None) -> list[RegistrationResult]:
    """Register many same-bucket static pairs concurrently; results in
    input order.  slots -> the fused stream's window width.  mesh: a
    dist/mesh.Mesh whose `data` axis the window splits over (the width
    rounded up to a multiple of it); every rank of it calls this with the
    same pairs and gets every result."""
    from goicp_tpu_torch.pipeline.pair import adapt_device_result
    from goicp_tpu_torch.search.fused_stream import register_fused_stream

    if any(p.dynamic_counts for p in pairs):
        raise ValueError("pass static pairs (make_count_dynamic pairs go "
                         "through register_fused_stream directly)")
    n = len(pairs)
    width = min(slots or n, n)
    if mesh is not None:
        d = mesh.n_data
        width = -(-max(width, d) // d) * d
    run_cfg = cfg if max_steps is None else dataclasses.replace(
        cfg, max_outer_steps=max_steps)
    t0 = time.time()
    out = register_fused_stream(pairs, run_cfg, width=width, chunk_steps=64,
                                mesh=mesh)
    per_pair_s = (time.time() - t0) / n
    return [adapt_device_result(type(out)(*(leaf[i] for leaf in out)),
                                pair.n_data, per_pair_s)
            for i, pair in enumerate(pairs)]
