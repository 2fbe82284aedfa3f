"""The bench: distinct-pair registration throughput on two pools.

Port of goicp_tpu/bench/measure.py.

    python -m goicp_tpu_torch.bench.measure OUT.json [--reference DIR |
        --no-reference] [--device cpu]

  * similar: with a reference directory (the BO1 data: cavities/ and
    config.txt), the two real BO1 pairs plus 62 synthetic pairs; without
    one (--no-reference) the 64 synthetic pairs syn00-syn63.  Synthetic
    pairs are rigidly transformed subsets of the model, properties carried
    along, in the BO1 cavity size envelope (165-306 points).
  * trimmed: 32 noisy pairs with ~10% unmatched outliers, registered with
    trimFraction 0.1 and a translation frontier of 256.

Both pools run through the cross-pair fused stream (width 2, 512-step
chunks) per shape bucket (4 similar, 3 trimmed): a warm run, then the best
wall of 2.  Every run is held to the checks of `_check_parity`, against
the fp32 reference rows of all 96 pairs (reference_rows.jsonl).  The pools
draw the very same clouds as the JAX functions from the same seeds; their
pairs are the `syn*` / `trm*` rows of sweep383.jsonl /
sweep383_trimmed.jsonl (TPU runs, whose counters fp32 reproduces for most
pairs, not all).  Writes one JSON object: pairs_per_s, bound_evals_per_s
(translation-node bound evaluations / wall), trimmed_pairs_per_s, the
walls and batch sizes, the device, and the pairs whose counters differ
from their sweep383 rows (sweep_rows_differ).

With device="cpu" it registers one pair three times with the host engine
instead (pair 1 with a reference directory, syn00 without).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import time

import numpy as np
import torch

from goicp_tpu_torch.geom.normalize import normalize_pair
from goicp_tpu_torch.geom.rotation import rodrigues_np
from goicp_tpu_torch.io.xyz import quantize_like_file

REPO = pathlib.Path(__file__).resolve().parents[2]
REF = str(REPO / "reference")    # the BO1 reference data, where it is put
REFERENCE_ROWS = pathlib.Path(__file__).with_name("reference_rows.jsonl")
# the fp32 rows of the next pairs by index, syn64-syn79 and trm32-trm39,
# which the 383-pair sweeps (goicp_tpu_torch/tools/sweep383.py) reach
SWEEP_FP32_ROWS = pathlib.Path(__file__).with_name("sweep_rows_fp32.jsonl")
BATCH = 64
TRIM_BATCH = 32
TRIM_FRACTION = 0.1  # the trimmed pool's trimFraction
FUSED_WIDTH = 2      # the fused stream's window
FUSED_CHUNK = 512    # global iterations per chunk
SIMILAR_BUCKETS = 4
TRIM_BUCKETS = 3
ERR_TOL = 1e-4       # |error - fp32 reference row|
TRIM_EVALS_REL = 0.05  # trimmed pairs: evals within 5 % of the fp32 row
# BO1 pairs 1 and 2 (source -> target cavity) and their sweep383 row names
REAL_PAIRS = (("2x86_3", "1eq2_6"), ("2ktd_1", "4imo_2"))
REAL_NAMES = ("similar1_2x86_3->1eq2_6", "similar2_2ktd_1->4imo_2")
GOLDEN_ERROR = 8.45388   # pair 1's error in the reference's output
GOLDEN_COMPAT = 133      # and its compatibilities


def bench_shape(cfg):
    """The bench's search shape: one rotation cube per outer step (8 lanes),
    a 128-node translation frontier, 4 ICP seeds, margin 0.9, chem corner
    reuse."""
    return dataclasses.replace(cfg, rot_batch=1, trans_capacity=128,
                               icp_seeds=4, max_outer_steps=12000,
                               margin_frac=0.9, chem_reuse=1)


def _synthetic_draw(rng):
    """A similar-style synthetic RAW pair: the data cloud is a rigidly
    transformed subset of the model cloud, properties carried along,
    coordinates rounded to 6 decimals.  Returns (data, model, data props,
    model props, the model rows of the data points)."""
    nm = int(rng.integers(165, 307))
    nd = int(rng.integers(165, nm + 1))
    model = rng.uniform(-0.75, 0.75, size=(nm, 3))
    R = rodrigues_np(rng.uniform(-2.5, 2.5, 3))
    tv = rng.uniform(-0.15, 0.15, 3)
    sel = rng.permutation(nm)[:nd]
    data = (model[sel] - tv) @ R
    mp = rng.integers(0, 9, nm).astype(np.int32)
    return (np.round(data, 6), np.round(model, 6),
            mp[sel].copy(), mp, sel)


def synthetic_pool(n: int, seed: int = 7):
    """[(name, data_raw f64 (Nd,3), model_raw f64 (Nm,3),
    data_prop_idx i32, model_prop_idx i32)] for syn00, syn01, ..."""
    rng = np.random.default_rng(seed)
    return [(f"syn{i:02d}",) + _synthetic_draw(rng)[:4] for i in range(n)]


def synthetic_aligned(n: int, seed: int = 7) -> dict:
    """{name: the data cloud's points in the model's frame (Nd, 3)} for the
    pairs of synthetic_pool(n, seed): the registration's ground truth,
    which the RMSD path of the pair runner compares against."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        _, model, _, _, sel = _synthetic_draw(rng)
        out[f"syn{i:02d}"] = model[sel]
    return out


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


def _load_real_pair(src_name: str, tgt_name: str, ref_dir: str):
    """The reference pipeline's load: mol2 -> common-scale normalize -> the
    write-then-reload 6-significant-digit quantization
    (jly_main.cpp:72-99)."""
    from goicp_tpu_torch.io.mol2 import read_mol_file

    src, sp = read_mol_file(f"{ref_dir}/cavities/{src_name}_cavity6.mol2")
    tgt, tp = read_mol_file(f"{ref_dir}/cavities/{tgt_name}_cavity6.mol2")
    norm = normalize_pair(src, tgt)
    return (quantize_like_file(norm["source"]),
            quantize_like_file(norm["target"]), sp, tp)


def similar_names(n_total: int = BATCH, ref_dir: str | None = None):
    """The similar pool's pair names, in pool order."""
    real = list(REAL_NAMES) if ref_dir else []
    return real + [e[0] for e in synthetic_pool(n_total - len(real))]


def _similar_raw(n_total: int = BATCH, ref_dir: str | None = None):
    """The similar pool's normalized pairs: the two real BO1 pairs first
    when ref_dir is given, then the synthetic fill."""
    raw = [_load_real_pair(s, t, ref_dir) for s, t in REAL_PAIRS] \
        if ref_dir else []
    return raw + [_normalized_synthetic(e)
                  for e in synthetic_pool(n_total - len(raw))]


def build_batch(cfg, n_total: int = BATCH, ref_dir: str | None = None,
                device=None):
    """The similar pool in ONE pool-max bucket, count-dynamic."""
    return _bucket_and_prepare(_similar_raw(n_total, ref_dir), cfg,
                               device=device)


def build_batch_buckets(cfg, n_total: int = BATCH, max_buckets: int = 3,
                        ref_dir: str | None = None, device=None):
    """The similar pool, shape-bucketed into up to max_buckets groups ->
    [(pairs, original_indices)]."""
    return _bucket_and_prepare_multi(_similar_raw(n_total, ref_dir), cfg,
                                     max_buckets, device=device)


def build_trimmed_batch(cfg, n_total: int = TRIM_BATCH, device=None):
    """The trimmed pool in ONE pool-max bucket; cfg must carry
    trimFraction=TRIM_FRACTION."""
    raw = [_normalized_synthetic(e) for e in synthetic_pool_trimmed(n_total)]
    return _bucket_and_prepare(raw, cfg, device=device)


def build_trimmed_batch_buckets(cfg, n_total: int = TRIM_BATCH,
                                max_buckets: int = 3, device=None):
    """The trimmed pool, shape-bucketed -> [(pairs, original_indices)]."""
    raw = [_normalized_synthetic(e) for e in synthetic_pool_trimmed(n_total)]
    return _bucket_and_prepare_multi(raw, cfg, max_buckets, device=device)


def _read_rows(path) -> dict:
    with open(path) as fh:
        return {r["pair"]: r for r in map(json.loads, fh) if r}


def reference_rows() -> dict:
    """{pair name: row} of the fp32 reference rows of all 96 bench pairs:
    the JAX package's register_device on XLA:CPU under GoICPConfig() +
    bench_shape (error, converged, outer, inner, evals, icp_runs)."""
    return _read_rows(REFERENCE_ROWS)


def fp32_rows() -> dict:
    """{pair name: row} of every fp32 row: reference_rows() and the rows
    of syn64-syn79 and trm32-trm39 (sweep_rows_fp32.jsonl, made the same
    way)."""
    return {**reference_rows(), **_read_rows(SWEEP_FP32_ROWS)}


def sweep_rows() -> dict:
    """{pair name: row} of sweep383.jsonl and sweep383_trimmed.jsonl: the
    JAX package's sweeps on a TPU v5e, whose counters fp32 does not always
    reproduce (sweep_row_differences)."""
    return {**_read_rows(REPO / "sweep383.jsonl"),
            **_read_rows(REPO / "sweep383_trimmed.jsonl")}


def _require(ok, what):
    if not ok:
        raise AssertionError(f"bench check failed: {what}")


def _check_parity(out, cfg, batch_pairs, names, rows=None):
    """The in-run checks of one pool's DeviceResult (pool order):
      * every pair converged;
      * BO1 pair 1, when the pool holds it, within the reference's epsilon
        MSEThresh*Nd of its golden error, compatibilities within 2;
      * the convergence-margin guard: with margin_frac < 1 every gap sits
        below margin_frac * MSEThresh * inliers (+1e-3), so a numeric
        perturbation cannot flip a pair to unconverged;
      * with rows (reference_rows() or fp32_rows()): each pair with an
        fp32 reference row within ERR_TOL of its error, each synthetic
        similar pair's outer, inner, evals and icp_runs equal to its row's,
        each trimmed pair's evals within TRIM_EVALS_REL of its row's."""
    err = np.asarray(out.error)
    conv = np.asarray(out.converged)
    _require(bool(conv.all()),
             f"unconverged pairs: {[names[i] for i in np.where(~conv)[0]]}")
    if names[0] == REAL_NAMES[0]:
        nd1 = float(batch_pairs[0].counts[0])
        comp = int(np.asarray(out.opt_comp)[0])
        _require(abs(float(err[0]) - GOLDEN_ERROR) < cfg.MSEThresh * nd1,
                 f"pair-1 parity: error {float(err[0])}")
        # the count can flip by one correspondence across backends
        _require(abs((int(nd1) - comp) - GOLDEN_COMPAT) <= 2,
                 f"pair-1 compatibilities {int(nd1) - comp}")
    if cfg.margin_frac < 1.0:
        gap = np.asarray(out.gap)
        for i, p in enumerate(batch_pairs):
            eps_i = cfg.MSEThresh * float(p.counts[1])
            _require(gap[i] <= cfg.margin_frac * eps_i + 1e-3,
                     f"margin guard {names[i]}: gap {float(gap[i])}, "
                     f"epsilon {eps_i}")
    if rows is None:
        return
    failures = fp32_row_failures(out, names, rows)
    _require(not failures, failures[0] if failures else "")


def fp32_row_failures(out, names, rows) -> list:
    """One message for each pair of `names` with a row in `rows` whose
    result misses it: error within ERR_TOL, a synthetic similar pair's
    outer, inner, evals and icp_runs equal, a trimmed pair's evals within
    TRIM_EVALS_REL."""
    err = np.asarray(out.error)
    got = _counters(out)
    failures = []
    for i, name in enumerate(names):
        row = rows.get(name)
        if row is None:
            continue
        msgs = []
        if not abs(float(err[i]) - row["error"]) <= ERR_TOL:
            msgs.append(f"error {float(err[i])} vs {row['error']}")
        if name.startswith("syn"):
            msgs += [f"{k} {int(v[i])} vs {row[k]}" for k, v in got.items()
                     if int(v[i]) != row[k]]
        elif name.startswith("trm"):
            ev = int(got["evals"][i])
            if not abs(ev - row["evals"]) <= TRIM_EVALS_REL * row["evals"]:
                msgs.append(f"evals {ev} vs {row['evals']}")
        if msgs:
            failures.append(f"{name} vs reference row: {', '.join(msgs)}")
    return failures


def _counters(out) -> dict:
    return dict(outer=np.asarray(out.outer_iters),
                inner=np.asarray(out.inner_iters),
                evals=np.asarray(out.evals),
                icp_runs=np.asarray(out.icp_runs))


def sweep_row_differences(out, names, rows) -> dict:
    """{pair name: {counter: (this run, sweep row)}} for the pairs whose
    outer, inner, evals or icp_runs differ from their sweep383 row (rows:
    sweep_rows())."""
    got = _counters(out)
    diff = {}
    for i, name in enumerate(names):
        row = rows.get(name)
        d = {k: (int(v[i]), row[k]) for k, v in got.items()
             if row is not None and int(v[i]) != row[k]}
        if d:
            diff[name] = d
    return diff


def _ordered(buckets, n):
    """[(pairs, original_indices)] -> the prepared pairs in pool order."""
    out = [None] * n
    for pairs, idxs in buckets:
        for p, i in zip(pairs, idxs):
            out[i] = p
    return out


def timed_pass(buckets, cfg, n, names, rows=None):
    """One pass of a bucketed pool through the fused stream, one stream per
    bucket, held to _check_parity.  Returns (wall s, DeviceResult of numpy
    arrays in pool order)."""
    from goicp_tpu_torch.search.fused_stream import register_fused_stream

    t0 = time.time()
    outs = [(idxs, register_fused_stream(bp, cfg, width=FUSED_WIDTH,
                                         chunk_steps=FUSED_CHUNK))
            for bp, idxs in buckets]
    wall = time.time() - t0
    out = _reassemble(outs, n)
    _check_parity(out, cfg, _ordered(buckets, n), names, rows)
    return wall, out


def _best_of_2(buckets, cfg, n, names, rows):
    """A warm pass, then the best wall of 2.  Returns (wall, evals of the
    best pass, names of the pairs whose counters differ from their sweep383
    rows)."""
    timed_pass(buckets, cfg, n, names, rows)
    best, evals = float("inf"), 0
    for _ in range(2):
        wall, out = timed_pass(buckets, cfg, n, names, rows)
        if wall < best:
            best, evals = wall, int(np.sum(out.evals))
    return best, evals, sorted(sweep_row_differences(out, names,
                                                     sweep_rows()))


def _nvidia_smi(index: int) -> str:
    """`name, power.limit` of one card, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(out_path: str, ref_dir: str | None = REF, device=None):
    """Measure both pools (or, on the CPU, one pair) and write the JSON
    object to out_path.  ref_dir None: no reference data (the synthetic
    similar pool; pair 1's golden checks left out).  device None means
    goicp_tpu_torch.default_device(), the card."""
    from goicp_tpu_torch import GoICPConfig, default_device

    dev = torch.device(device) if device is not None else default_device()
    if ref_dir is not None and not os.path.isdir(ref_dir):
        raise FileNotFoundError(
            f"reference directory {ref_dir} not found (pass "
            "--no-reference to bench the synthetic pools alone)")
    cfg = bench_shape(GoICPConfig.from_file(f"{ref_dir}/config.txt")
                      if ref_dir else GoICPConfig())
    rows = reference_rows()
    names = similar_names(BATCH, ref_dir)
    result = {"platform": "cpu" if dev.type == "cpu" else "gpu",
              "real_pairs": 2 if ref_dir else 0}

    if dev.type == "cpu":
        # sequential single-pair host engine: no lane-parallel hardware
        from goicp_tpu_torch.pipeline.prepare import prepare_pair
        from goicp_tpu_torch.search.outer import register
        if ref_dir:
            raw, nd_ds = _load_real_pair(*REAL_PAIRS[0], ref_dir), 238
            want = GOLDEN_ERROR
        else:
            raw, nd_ds = _normalized_synthetic(synthetic_pool(1)[0]), 0
            want = rows["syn00"]["error"]
        pair = prepare_pair(*raw, cfg, nd_downsampled=nd_ds, bucket=True,
                            device=dev)
        eps = cfg.MSEThresh * pair.n_data
        n, evals, wall = 3, 0, 0.0
        for rep in range(n + 1):                  # a warm run, then n
            t0 = time.time()
            r = register(pair, cfg)
            if rep:
                wall += time.time() - t0
                evals += r.bound_evals
            _require(r.converged and abs(r.error - want) < eps,
                     f"host engine error {r.error} vs {want} (eps {eps})")
        result.update(pairs_per_s=n / wall, bound_evals_per_s=evals / wall,
                      wall_s=wall, batch=n, distinct_pairs=1)
    else:
        result.update(device=torch.cuda.get_device_name(dev),
                      nvidia_smi=_nvidia_smi(dev.index or 0))
        buckets = build_batch_buckets(cfg, BATCH, SIMILAR_BUCKETS, ref_dir,
                                      device=dev)
        wall, evals, differ = _best_of_2(buckets, cfg, BATCH, names, rows)
        cfg_t = dataclasses.replace(cfg, trimFraction=TRIM_FRACTION,
                                    trans_capacity=256)
        tbuckets = build_trimmed_batch_buckets(cfg_t, TRIM_BATCH,
                                               TRIM_BUCKETS, device=dev)
        tnames = [e[0] for e in synthetic_pool_trimmed(TRIM_BATCH)]
        twall, _, tdiffer = _best_of_2(tbuckets, cfg_t, TRIM_BATCH, tnames,
                                       rows)
        result.update(pairs_per_s=BATCH / wall,
                      bound_evals_per_s=evals / wall, wall_s=wall,
                      batch=BATCH, distinct_pairs=BATCH,
                      trimmed_pairs_per_s=TRIM_BATCH / twall,
                      trimmed_wall_s=twall, trimmed_batch=TRIM_BATCH,
                      sweep_rows_differ=differ + tdiffer)
    with open(out_path, "w") as fh:
        json.dump(result, fh)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m goicp_tpu_torch.bench.measure")
    ap.add_argument("out", help="where the JSON object is written")
    ref = ap.add_mutually_exclusive_group()
    ref.add_argument("--reference", default=REF,
                     help="the BO1 reference data directory (cavities/, "
                          "config.txt)")
    ref.add_argument("--no-reference", dest="reference",
                     action="store_const", const=None,
                     help="bench the synthetic pools alone")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    print(json.dumps(main(args.out, args.reference, args.device)))
