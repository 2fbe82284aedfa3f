"""The bench's search shape, synthetic pair pools and bucketed preparation.

Port of the pool half of goicp_tpu/bench/measure.py (:44-198).  The pools
draw the very same clouds as the JAX functions from the same seeds: the
similar pool (rigidly transformed subsets of the model, properties carried
along) and the trimmed pool (noisy subsets plus ~10% unmatched outliers),
both in the BO1 cavity size envelope (165-306 points).  Their pairs are the
`syn*` / `trm*` rows of sweep383.jsonl / sweep383_trimmed.jsonl.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from goicp_tpu_torch.geom.normalize import normalize_pair
from goicp_tpu_torch.geom.rotation import rodrigues_np
from goicp_tpu_torch.io.xyz import quantize_like_file

TRIM_FRACTION = 0.1  # the trimmed pool's trimFraction


def bench_shape(cfg):
    """The bench's search shape: one rotation cube per outer step (8 lanes),
    a 128-node translation frontier, 4 ICP seeds, margin 0.9, chem corner
    reuse."""
    return dataclasses.replace(cfg, rot_batch=1, trans_capacity=128,
                               icp_seeds=4, max_outer_steps=12000,
                               margin_frac=0.9, chem_reuse=1)


def _synthetic_pair(rng):
    """A similar-style synthetic RAW pair: the data cloud is a rigidly
    transformed subset of the model cloud, properties carried along,
    coordinates rounded to 6 decimals."""
    nm = int(rng.integers(165, 307))
    nd = int(rng.integers(165, nm + 1))
    model = rng.uniform(-0.75, 0.75, size=(nm, 3))
    R = rodrigues_np(rng.uniform(-2.5, 2.5, 3))
    tv = rng.uniform(-0.15, 0.15, 3)
    sel = rng.permutation(nm)[:nd]
    data = (model[sel] - tv) @ R
    mp = rng.integers(0, 9, nm).astype(np.int32)
    return (np.round(data, 6), np.round(model, 6),
            mp[sel].copy(), mp)


def synthetic_pool(n: int, seed: int = 7):
    """[(name, data_raw f64 (Nd,3), model_raw f64 (Nm,3),
    data_prop_idx i32, model_prop_idx i32)] for syn00, syn01, ..."""
    rng = np.random.default_rng(seed)
    return [(f"syn{i:02d}",) + _synthetic_pair(rng) for i in range(n)]


def _synthetic_pair_noisy(rng):
    """A dissimilar-style synthetic RAW pair: rigid subset PLUS coordinate
    noise and unmatched outlier points (~10% of the data cloud, below the
    pool's trimFraction)."""
    nm = int(rng.integers(165, 307))
    n_match = int(rng.integers(150, min(nm, 270) + 1))
    n_out = max(1, int(0.10 * n_match / 0.9))
    model = rng.uniform(-0.75, 0.75, size=(nm, 3))
    R = rodrigues_np(rng.uniform(-2.5, 2.5, 3))
    tv = rng.uniform(-0.15, 0.15, 3)
    sel = rng.permutation(nm)[:n_match]
    matched = (model[sel] - tv) @ R
    matched = matched + rng.normal(0.0, 0.004, size=matched.shape)
    outliers = rng.uniform(-0.9, 0.9, size=(n_out, 3))
    data = np.vstack([matched, outliers])
    mp = rng.integers(0, 9, nm).astype(np.int32)
    dp = np.concatenate([mp[sel], rng.integers(0, 9, n_out)]).astype(
        np.int32)
    perm = rng.permutation(len(data))
    return (np.round(data[perm], 6), np.round(model, 6),
            dp[perm].copy(), mp)


def synthetic_pool_trimmed(n: int, seed: int = 23):
    """Noisy/outlier raw pairs trm00, trm01, ... (registered with
    trimFraction=TRIM_FRACTION)."""
    rng = np.random.default_rng(seed)
    return [(f"trm{i:02d}",) + _synthetic_pair_noisy(rng)
            for i in range(n)]


def _normalized_synthetic(entry):
    """Raw synthetic pair -> the normalized quantized clouds the engine
    registers (centralize each, common scale, 6-significant-digit file
    round-trip — jly_main.cpp:83-99)."""
    _, data, model, dp, mp = entry
    norm = normalize_pair(data, model)
    return (quantize_like_file(norm["source"]),
            quantize_like_file(norm["target"]), dp, mp)


def _bucket_and_prepare(raw, cfg, device=None):
    """Prepare normalized pairs [(data, model, dp, mp)] into ONE pool-max
    shape bucket, count-dynamic, so a cross-pair stream can stack them."""
    from goicp_tpu_torch.pipeline.prepare import (bucket_dims,
                                                  make_count_dynamic,
                                                  prepare_pair)
    dims: dict = {}
    for data, model, _, _ in raw:
        d = bucket_dims(model, len(data), len(model), cfg)
        dims = {k: max(dims.get(k, 0), v) for k, v in d.items()}
    return [make_count_dynamic(
        prepare_pair(data, model, dp, mp, cfg, device=device, **dims))
        for data, model, dp, mp in raw]


def _bucket_and_prepare_multi(raw, cfg, max_buckets: int = 3, device=None):
    """Shape-BUCKETED prep: pairs grouped by their own kernel dims instead
    of one pool-max bucket (plan_buckets).  One stream runs per bucket;
    trajectories are padding-invariant, so per-pair results and eval counts
    are those of the single-bucket protocol.
    Returns [(pairs, original_indices)]."""
    from goicp_tpu_torch.pipeline.prepare import (bucket_dims,
                                                  make_count_dynamic,
                                                  plan_buckets, prepare_pair)
    dims_list = [bucket_dims(m, len(d), len(m), cfg) for d, m, _, _ in raw]
    plan = plan_buckets(dims_list, max_buckets=max_buckets)
    return [([make_count_dynamic(prepare_pair(*raw[i], cfg, device=device,
                                              **bd))
              for i in idxs], idxs) for bd, idxs in plan]


def _reassemble(outs, n: int):
    """[(original_indices, DeviceResult batch)] -> DeviceResult rows in
    original pair order (the per-bucket streams' inverse permutation)."""
    from goicp_tpu_torch.search.device_engine import DeviceResult
    rows = [None] * n
    for idxs, out in outs:
        for j, i in enumerate(idxs):
            rows[i] = tuple(np.asarray(getattr(out, f))[j]
                            for f in DeviceResult._fields)
    return DeviceResult(*(np.stack([r[k] for r in rows])
                          for k in range(len(DeviceResult._fields))))
