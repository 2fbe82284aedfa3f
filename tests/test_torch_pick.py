"""The end of an ICP event (goicp_tpu_torch/search/pick.py: the seeds, the
pick of the best seed with the candidate's count written into the refine
record, the initial incumbent) and its kernels (csrc/score.cu's
goicp_icp_seeds and goicp_score_pick), held on the CPU:

  * the plain routes equal the JAX package's _icp_best_of_seeds (with
    bnb_incompatibility_count at the candidate) and _initial_incumbent
    on XLA:CPU, from numpy inputs made from a seed: indices and counts
    exactly, errors, transforms and terms to 1e-5 absolute; icp_seeds 1
    and 4 (ubs with ties), init_seeds 1 and 4, untrimmed and a dynamic
    trim;
  * the seeds' order (the kernel's rank by counting, NaN last) equals
    torch.argsort(stable=True)'s and JAX's lax.top_k(-ubs, K)'s on ubs
    with ties and inf, and the pick's first minimum (the kernel's rule)
    torch.argmin's and jnp.argmin's on errors with ties and NaN;
  * a refine record of several rows: the rows that refine equal a lone
    refinement, the others the dummy (transition.refine_rows'), whatever
    the record held before;
  * register_device and a fused-stream window on short bench pairs give
    the reference rows (bench/reference_rows.jsonl) as before;
  * CPU tensors take the plain routes and launch nothing.

The `cuda` tests hold each kernel to its plain route on the card (they
skip without one); chip_smoke.py phase 2 does the same at the main
path's shapes.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.geom.rotation import rodrigues_np
from goicp_tpu_torch.pipeline import prepare as tprep
from goicp_tpu_torch.search import device_engine as teng
from goicp_tpu_torch.search import pick, transition
from goicp_tpu_torch.search.args import RefineRecord, RefineRows

torch.set_num_threads(1)

F32 = np.float32
REPO = pathlib.Path(__file__).resolve().parents[1]
BASE = dict(regularization=0.0005, ponderation=1, distTransSize=12)
# configuration, data points, padded length, dynamic counts
CASES = {"l2": (dict(), 48, None, False),
         "dynamic trim": (dict(trimFraction=0.15), 48, 64, True)}
TOL = 1e-5


def clouds(n, m=56, seed=7):
    """(data, model, data props, model props): the data a rotated,
    shifted, noisy copy of the model's first n points."""
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.7, 0.7, (m, 3))
    R = rodrigues_np(rng.uniform(-0.3, 0.3, 3))
    t = rng.uniform(-0.05, 0.05, 3)
    data = (model[:n] - t) @ R + rng.normal(0, 0.01, (n, 3))
    mp = rng.integers(0, 9, m).astype(np.int32)
    dp = mp[:n].copy()
    dp[::5] = (dp[::5] + 1) % 9            # some incompatible points
    return data.astype(F32), model.astype(F32), dp, mp


def pairs(case, **over):
    """(port cfg, JAX cfg, port pair, JAX pair) of a small case."""
    from goicp_tpu.config import GoICPConfig as JConfig
    from goicp_tpu.pipeline import prepare as jprep
    kw, n, pad, dynamic = CASES[case]
    kw = dict(BASE, **kw, **over)
    jp = jprep.prepare_pair(*clouds(n), JConfig(**kw), pad_data_to=pad)
    if dynamic:
        jp = jprep.make_count_dynamic(jp)
    return (GoICPConfig(**kw), JConfig(**kw), tprep.pair_from_jax(jp, "cpu"),
            jp)


def lanes(L, seed, ties=True):
    """(R_lanes (L, 3, 3), best_nodes (L, 4), ubs (L,)) float32 numpy:
    rotations near the identity, translation nodes near the origin, ubs
    of four values (ties) or distinct."""
    rng = np.random.default_rng(seed)
    R = np.stack([rodrigues_np(rng.uniform(-0.4, 0.4, 3))
                  for _ in range(L)]).astype(F32)
    nodes = np.concatenate([rng.uniform(-0.06, 0.06, (L, 3)),
                            rng.uniform(0.01, 0.04, (L, 1))], 1).astype(F32)
    ubs = (rng.integers(0, 4, L) if ties else rng.uniform(0, 4, L))
    return R, nodes, ubs.astype(F32)


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=TOL, err_msg=what)


# ---------------------------------------------------------------------------
# the plain routes against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,case", [(1, "l2"), (4, "l2"),
                                    (4, "dynamic trim")])
def test_refinement_matches_jax(K, case):
    import jax.numpy as jnp
    from goicp_tpu.bounds import error as jerr
    from goicp_tpu.search import device_engine as jeng
    cfg, jcfg, tp, jp = pairs(case, icp_seeds=K, rot_batch=2)
    R_l, nodes, ubs = lanes(16, seed=K)
    cand_R, cand_t = R_l[5], nodes[5, :3] + nodes[5, 3] / F32(2)
    jR, jt, jsc, jinc = jeng._icp_best_of_seeds(
        jp, jcfg, jnp.asarray(R_l), jnp.asarray(nodes), jnp.asarray(ubs))
    jbnb = jerr.bnb_incompatibility_count(jp, jcfg, jnp.asarray(cand_R),
                                          jnp.asarray(cand_t))
    rec = pick.refine_rows(cfg, [(0, tp, *map(torch.from_numpy, (
        R_l, nodes, ubs, cand_R, cand_t)))], 1, "cpu")
    close(rec["icp_R"][0], jR, "icp_R")
    close(rec["icp_t"][0], jt, "icp_t")
    close(rec["icp_err"][0], jsc.error, "icp_err")
    close(rec["icp_terms"][0], [jsc.geom, jsc.incomp_term + jsc.nbr_term,
                                jsc.fpfh_term], "icp_terms")
    assert int(rec["icp_incomp"][0]) == int(jinc)
    assert int(rec["bnb_comp"][0]) == int(jbnb)
    assert bool(rec["do_icp"][0])


@pytest.mark.parametrize("K,case", [(1, "l2"), (4, "dynamic trim")])
def test_initial_incumbent_matches_jax(K, case):
    from goicp_tpu.search import device_engine as jeng
    cfg, jcfg, tp, jp = pairs(case, init_seeds=K)
    want = jeng._initial_incumbent(jp, jcfg)
    got = teng._initial_incumbent(tp, cfg)
    for name, g, w in zip(("opt_err", "opt_R", "opt_t", "comp", "terms",
                           "better"), got, want):
        if name in ("comp", "better"):
            assert int(g) == int(w), name
        else:
            close(g, w, name)


def test_seeds_match_jax_top_k_with_ties():
    import jax
    import jax.numpy as jnp
    R_l, nodes, ubs = lanes(16, seed=3)
    for K in (1, 4, 8, 16):
        _, want = jax.lax.top_k(-jnp.asarray(ubs), K)
        want = np.asarray(want)
        got_R, got_t = pick.icp_seeds_plain(*map(torch.from_numpy,
                                                 (ubs, R_l, nodes)), K)
        np.testing.assert_array_equal(got_R.numpy(), R_l[want])
        np.testing.assert_array_equal(
            got_t.numpy(), nodes[want, :3] + nodes[want, 3:4] / F32(2))


# ---------------------------------------------------------------------------
# the kernels' rules as numpy models
# ---------------------------------------------------------------------------

def seeds_model(ubs, K):
    """csrc/score.cu's icp_seeds_kernel: each lane's rank, the count of
    lanes that sort before it (NaN last, ties to the lower lane); the
    lanes of rank < K in rank order."""
    def before(v, q, u, i):
        if np.isnan(v):
            return bool(np.isnan(u)) and q < i
        if np.isnan(u):
            return True
        return v < u or (v == u and q < i)
    L = len(ubs)
    rank = [sum(before(ubs[q], q, ubs[i], i) for q in range(L))
            for i in range(L)]
    out = [None] * K
    for i, r in enumerate(rank):
        if r < K:
            out[r] = i
    return out


def first_min_model(err):
    """csrc/score.cu's first_min: the first NaN where there is one, else
    the first least error."""
    bi, best = 0, err[0]
    for i in range(1, len(err)):
        if np.isnan(best):
            break
        if np.isnan(err[i]) or err[i] < best:
            bi, best = i, err[i]
    return bi


def test_seed_rank_model_is_stable_argsort_and_top_k():
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    for trial in range(40):
        L = int(rng.integers(1, 40))
        ubs = rng.integers(0, 5, L).astype(F32)
        ubs[rng.random(L) < 0.2] = np.inf
        nan = trial % 2 == 1
        if nan:
            ubs[rng.random(L) < 0.15] = np.nan
        order = torch.argsort(torch.from_numpy(ubs), stable=True).tolist()
        for K in {1, min(4, L), L}:
            got = seeds_model(ubs, K)
            assert got == order[:K], (ubs, K)
            if not nan:
                _, want = jax.lax.top_k(-jnp.asarray(ubs), K)
                assert got == np.asarray(want).tolist(), (ubs, K)


def test_first_min_model_is_argmin_with_ties_and_nan():
    import jax.numpy as jnp
    rng = np.random.default_rng(12)
    for trial in range(60):
        K = int(rng.integers(1, 14))
        err = rng.integers(0, 3, K).astype(F32)      # ties
        if trial % 3 == 1:
            err[rng.random(K) < 0.3] = np.nan
        if trial % 3 == 2:
            err[rng.random(K) < 0.3] = np.inf
        got = first_min_model(err)
        assert got == int(torch.argmin(torch.from_numpy(err))), err
        assert got == int(jnp.argmin(jnp.asarray(err))), err


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

def test_reset_is_the_dummy_row():
    """The dummy of a row that did not refine: identity, 0, inf, 0, 0, 0,
    do_icp False (what advance takes for no refinement)."""
    rec = RefineRows(3, "cpu")
    for v in rec.values():
        v.view(torch.uint8).fill_(1)
    transition.reset_refine(rec)
    want = dict(icp_R=torch.eye(3).repeat(3, 1, 1), icp_t=torch.zeros(3, 3),
                icp_err=torch.full((3,), float("inf")),
                icp_terms=torch.zeros(3, 3),
                icp_incomp=torch.zeros(3, dtype=torch.int32),
                bnb_comp=torch.zeros(3, dtype=torch.int32),
                do_icp=torch.zeros(3, dtype=torch.bool))
    assert list(rec) == list(want)
    for k, v in want.items():
        assert torch.equal(rec[k], v), k
        assert torch.equal(transition.refine_rows(3, "cpu")[k], v), k
    assert rec.ptrs is None


def test_record_rows_that_refine_and_the_rest():
    cfg, _, tp, _ = pairs("l2", icp_seeds=4, rot_batch=2)
    todo = []
    for j in (0, 2):
        R_l, nodes, ubs = map(torch.from_numpy, lanes(16, seed=20 + j))
        todo.append((j, tp, R_l, nodes, ubs, R_l[j].contiguous(),
                     nodes[j, :3] + nodes[j, 3] / 2.0))
    record = RefineRecord()
    stale = record.rows(3, "cpu")
    for v in stale.values():
        v.view(torch.uint8).fill_(1)                # an earlier transition
    rec = pick.refine_rows(cfg, todo, 3, "cpu", record)
    assert rec is stale                             # kept for the run
    dummy = transition.refine_rows(1, "cpu")
    for k in rec:
        assert torch.equal(rec[k][1], dummy[k][0]), k
    for j, item in zip((0, 2), todo):
        alone = pick.refine_rows(cfg, [(0, *item[1:])], 1, "cpu")
        for k in rec:
            assert torch.equal(rec[k][j], alone[k][0]), (j, k)
    assert pick.refine_rows(cfg, [], 3, "cpu", record) is None
    # every row refines: no reset, each row the pick's
    rec = pick.refine_rows(cfg, [(j, *item[1:]) for j, item in
                                 enumerate(todo)], 2, "cpu", record)
    assert bool(rec["do_icp"].all())


def test_cpu_tensors_take_the_plain_routes_and_launch_nothing():
    cfg, _, tp, _ = pairs("dynamic trim", icp_seeds=4, rot_batch=2)
    R_l, nodes, ubs = map(torch.from_numpy, lanes(16, seed=4))
    counters = (pick.icp_seeds, pick.score_pick, pick.score_initial)
    before = [k.launches for k in counters]
    seed_R, seed_t = pick.icp_seeds(ubs, R_l, nodes, 4)
    want = pick.icp_seeds_plain(ubs, R_l, nodes, 4)
    assert torch.equal(seed_R, want[0]) and torch.equal(seed_t, want[1])
    got = pick.initial_incumbent(tp, cfg)
    assert set(got) == {"opt_err", "opt_R", "opt_t", "comp", "terms",
                        "last_icp"}
    assert [k.launches for k in counters] == before


# ---------------------------------------------------------------------------
# the engines on short bench pairs
# ---------------------------------------------------------------------------

def _bench_pairs(names):
    from goicp_tpu_torch.bench.measure import (_normalized_synthetic,
                                               bench_shape, synthetic_pool)
    cfg = bench_shape(GoICPConfig())
    pool = {e[0]: e for e in synthetic_pool(16, seed=7)}
    return cfg, [_normalized_synthetic(pool[n]) for n in names]


def _rows(names):
    with open(REPO / "goicp_tpu_torch" / "bench" / "reference_rows.jsonl") \
            as fh:
        rows = {r["pair"]: r for r in map(json.loads, fh)}
    return [rows[n] for n in names]


def _same_row(error, counters, row):
    assert abs(error - row["error"]) <= TOL
    assert counters == {k: row[k] for k in ("outer", "inner", "evals",
                                            "icp_runs")}


def test_register_device_and_a_stream_window_give_the_rows():
    from goicp_tpu_torch.bench.measure import _bucket_and_prepare
    from goicp_tpu_torch.search.fused_stream import register_fused_stream
    names = ("syn13", "syn01")
    cfg, raw = _bench_pairs(names)
    rows = _rows(names)
    one = tprep.make_count_dynamic(tprep.prepare_pair(*raw[0], cfg,
                                                      bucket=True,
                                                      device="cpu"))
    r = teng.register_device(one, cfg)
    _same_row(float(r.error), dict(outer=int(r.outer_iters),
                                   inner=int(r.inner_iters),
                                   evals=int(r.evals),
                                   icp_runs=int(r.icp_runs)), rows[0])
    out = register_fused_stream(_bucket_and_prepare(raw, cfg, device="cpu"),
                                cfg, width=2, chunk_steps=512)
    for i, row in enumerate(rows):
        _same_row(float(out.error[i]), dict(
            outer=int(out.outer_iters[i]), inner=int(out.inner_iters[i]),
            evals=int(out.evals[i]), icp_runs=int(out.icp_runs[i])), row)


# ---------------------------------------------------------------------------
# on the card: the kernels vs the plain routes
# ---------------------------------------------------------------------------

def _card_pair(case, **over):
    kw, n, pad, dynamic = CASES[case]
    cfg = GoICPConfig(**dict(BASE, **kw, **over))
    pair = tprep.prepare_pair(*clouds(n), cfg, pad_data_to=pad,
                              device="cuda")
    return cfg, tprep.make_count_dynamic(pair) if dynamic else pair


def _same(a, b):
    return all(torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8))
               for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4, 8, 12])
def test_seeds_kernel_equals_plain_on_the_card(K):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    R_l, nodes, ubs = (torch.from_numpy(x).cuda() for x in lanes(16, K))
    rec, rec_p = RefineRows(3, "cuda"), RefineRows(3, "cuda")
    got = pick.icp_seeds(ubs, R_l, nodes, K, reset=rec)
    want = pick.icp_seeds_plain(ubs, R_l, nodes, K, reset=rec_p)
    assert _same(got, want)
    assert _same(rec.values(), rec_p.values())


@pytest.mark.cuda
@pytest.mark.parametrize("K,case", [(1, "l2"), (4, "dynamic trim"),
                                    (8, "l2"), (12, "dynamic trim")])
def test_pick_and_initial_equal_plain_on_the_card(K, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, pair = _card_pair(case)
    rng = np.random.default_rng(K)
    R0 = torch.as_tensor(np.stack([rodrigues_np(v) for v in rng.uniform(
        -0.3, 0.3, (K, 3))]), dtype=torch.float32, device="cuda")
    t0 = torch.as_tensor(rng.uniform(-0.05, 0.05, (K, 3)),
                         dtype=torch.float32, device="cuda")
    from goicp_tpu_torch.icp.icp import icp_run
    r = icp_run(pair.data, pair.model, R0, t0, **pick.icp_kw(pair, cfg))
    R, t, nn = (torch.cat([x, x]) for x in (r.R, r.t, r.nn_idx))  # ties
    rec, rec_p = RefineRows(2, "cuda"), RefineRows(2, "cuda")
    for x in (rec, rec_p):
        transition.reset_refine(x)
    pick.score_pick(pair, cfg, R, t, nn, R0[0], t0[0], rec, 1)
    pick.score_pick_plain(pair, cfg, R, t, nn, R0[0], t0[0], rec_p, 1)
    assert _same(rec.values(), rec_p.values())
    got = pick.score_initial(pair, cfg, R, t, nn)
    want = pick.score_initial_plain(pair, cfg, R, t, nn)
    assert _same(got.values(), want.values())
