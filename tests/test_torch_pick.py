"""The end of an ICP event (goicp_tpu_torch/search/pick.py: the seeds, the
pick of the best seed with the candidate's count written into the refine
record, the initial incumbent) and its kernels (csrc/score.cu's
goicp_icp_seeds and goicp_score_pick; csrc/icp.cu's refine and initial
routes), held on the CPU:

  * the plain routes equal the JAX package's _icp_best_of_seeds (with
    bnb_incompatibility_count at the candidate) and _initial_incumbent
    on XLA:CPU, from numpy inputs made from a seed: indices and counts
    exactly, errors, transforms and terms to 1e-5 absolute; icp_seeds 1
    and 4 (ubs with ties), init_seeds 1, 4 and 8, untrimmed, a dynamic
    and a static trim;
  * the seeds' order (the kernel's rank by counting, NaN last) equals
    torch.argsort(stable=True)'s and JAX's lax.top_k(-ubs, K)'s on ubs
    with ties and inf, and the pick's first minimum (the kernel's rule)
    torch.argmin's and jnp.argmin's on errors with ties and NaN;
  * the split rescoring's ranks (score_body.cuh's score_row_cluster: each
    block its share of the points, G threads a point) are a stable
    argsort's positions on ties, inf and NaN;
  * a refine record of several rows: the rows that refine equal a lone
    refinement, the others the dummy (transition.dummy_refine_rows'),
    whatever the record held before; a window of three rows from two
    pairs, one row not refining, each refining row equal to the JAX
    package's _icp_best_of_seeds and its candidate's count;
  * the refine route's argument block (icp_refine down the card's route
    on CPU tensors, the C function replaced by a recorder): every row's
    pointers and record row, the ints, the slots checked again only where
    a row holds other tensors, rows of other shapes refused;
  * register_device and a fused-stream window on short bench pairs give
    the reference rows (bench/reference_rows.jsonl) as before;
  * CPU tensors take the plain routes and launch nothing, the engines'
    initialisation too.

The `cuda` tests hold each kernel to its plain route on the card (they
skip without one), the refine route (csrc/icp.cu, one launch for a
transition's refining rows) to both the plain composition and the three
launches a row it replaced, and the initial route (one launch an initial
incumbent) to the plain composition and the two launches it replaced,
bit for bit; chip_smoke.py phase 2 does the same at the main path's
shapes.
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
         "dynamic trim": (dict(trimFraction=0.15), 48, 64, True),
         "static trim": (dict(trimFraction=0.15), 48, None, False),
         "one block": (dict(), 30, None, False)}     # C = 1 on the card
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


def pairs(case, seed=7, pad_cells=None, **over):
    """(port cfg, JAX cfg, port pair, JAX pair) of a small case (the clouds
    made from `seed`; pad_cells: the grid's cells padded to that many, a
    shape two pairs can share)."""
    from goicp_tpu.config import GoICPConfig as JConfig
    from goicp_tpu.pipeline import prepare as jprep
    kw, n, pad, dynamic = CASES[case]
    kw = dict(BASE, **kw, **over)
    jp = jprep.prepare_pair(*clouds(n, seed=seed), JConfig(**kw),
                            pad_data_to=pad, pad_cells=pad_cells)
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


@pytest.mark.parametrize("K,case", [(1, "l2"), (4, "dynamic trim"),
                                    (8, "static trim")])
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


def rank_before(u, j, v, i):
    """score_body.cuh's rank_part term: does (u, j) come before (v, i) in
    a stable ascending sort, NaN last?"""
    if np.isnan(v):
        return (not np.isnan(u)) or j < i
    return bool(u < v or (u == v and j < i))


def cluster_ranks_model(vals, C, threads=512):
    """score_row_cluster's ranks: block r of C takes the share [r per, r
    per + nb) (csrc/icp.cu's icp_share, per = ceil(Nd / C)), G threads a
    point (the largest power of two <= 32 with nb G <= threads), thread g
    of a point counting over j = g, g + G, ...; the G counts added.
    Returns (each point's rank, the block that ranked it)."""
    nd = len(vals)
    per = -(-nd // C)
    rank, block = [None] * nd, [None] * nd
    for r in range(C):
        lo = r * per
        nb = max(0, min(nd - lo, per))
        g_log = 5
        while g_log > 0 and (nb << g_log) > threads:
            g_log -= 1
        G = 1 << g_log
        for i in range(lo, lo + nb):
            assert rank[i] is None                 # one share a point
            rank[i] = sum(sum(rank_before(vals[j], j, vals[i], i)
                              for j in range(g, nd, G)) for g in range(G))
            block[i] = r
    return rank, block


@pytest.mark.parametrize("nd", [33, 64, 192, 306])
def test_cluster_rank_model_is_stable_argsort(nd):
    """The split rescoring's ranks over C = min(8, ceil(Nd / 32)) blocks
    (and over 2 and 8 blocks) are the positions of a stable argsort, on
    values with ties, inf and NaN: each point placed at its rank gives
    torch.sort's values bit for bit (what the trimmed sum reads)."""
    rng = np.random.default_rng(nd)
    for trial in range(3):
        vals = rng.integers(0, 6, nd).astype(F32) / F32(4)     # ties
        vals[rng.random(nd) < 0.2] = np.inf
        if trial > 0:
            vals[rng.random(nd) < 0.1] = np.nan
        order = torch.argsort(torch.from_numpy(vals), stable=True).tolist()
        for C in sorted({min(8, -(-nd // 32)), 2, 8}):
            rank, block = cluster_ranks_model(vals, C)
            assert sorted(set(block)) == list(range(min(C, len(set(block)))))
            assert [order[r] for r in rank] == list(range(nd)), (nd, C)
            placed = np.empty(nd, F32)
            placed[rank] = vals
            want = torch.sort(torch.from_numpy(vals), stable=True).values
            assert np.array_equal(placed.view(np.uint32),
                                  want.numpy().view(np.uint32)), (nd, C)


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
        assert torch.equal(transition.dummy_refine_rows(3, "cpu")[k], v), k
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
    dummy = transition.dummy_refine_rows(1, "cpu")
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


def _window_todo(pair_a, pair_b, K_seed=30):
    """A window of three rows: row 0 refines on pair_a, row 2 on pair_b,
    row 1 does not refine; each row's lanes (16, tied ubs) and candidate
    made from a seed."""
    todo = []
    for j, tp in ((0, pair_a), (2, pair_b)):
        R_l, nodes, ubs = lanes(16, seed=K_seed + j)
        cand_R = R_l[j + 1]
        cand_t = nodes[j + 1, :3] + nodes[j + 1, 3] / F32(2)
        todo.append((j, tp, R_l, nodes, ubs, cand_R, cand_t))
    return todo


@pytest.mark.parametrize("case", ["l2", "dynamic trim"])
@pytest.mark.parametrize("K", [1, 4])
def test_window_refinement_matches_jax(K, case):
    import jax.numpy as jnp
    from goicp_tpu.bounds import error as jerr
    from goicp_tpu.search import device_engine as jeng
    cfg, jcfg, tp_a, jp_a = pairs(case, icp_seeds=K, rot_batch=2)
    _, _, tp_b, jp_b = pairs(case, seed=8, icp_seeds=K, rot_batch=2)
    todo = _window_todo(tp_a, tp_b)
    record = RefineRecord()
    for v in record.rows(3, "cpu").values():
        v.view(torch.uint8).fill_(1)                # an earlier transition
    rec = pick.refine_rows(cfg, [(j, tp, *map(torch.from_numpy, rest))
                                 for j, tp, *rest in todo], 3, "cpu", record)
    for (j, _, R_l, nodes, ubs, cand_R, cand_t), jp in zip(todo,
                                                           (jp_a, jp_b)):
        jR, jt, jsc, jinc = jeng._icp_best_of_seeds(
            jp, jcfg, jnp.asarray(R_l), jnp.asarray(nodes),
            jnp.asarray(ubs))
        jbnb = jerr.bnb_incompatibility_count(jp, jcfg, jnp.asarray(cand_R),
                                              jnp.asarray(cand_t))
        close(rec["icp_R"][j], jR, f"icp_R row {j}")
        close(rec["icp_t"][j], jt, f"icp_t row {j}")
        close(rec["icp_err"][j], jsc.error, f"icp_err row {j}")
        close(rec["icp_terms"][j], [jsc.geom, jsc.incomp_term + jsc.nbr_term,
                                    jsc.fpfh_term], f"icp_terms row {j}")
        assert int(rec["icp_incomp"][j]) == int(jinc), j
        assert int(rec["bnb_comp"][j]) == int(jbnb), j
        assert bool(rec["do_icp"][j]), j
    dummy = transition.dummy_refine_rows(1, "cpu")
    for k in rec:
        assert torch.equal(rec[k][1], dummy[k][0]), k


class _RefineRecorder:
    """goicp_icp_refine's stand-in: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def goicp_icp_refine(self, slots, j, n, ints, floats, rec, n_rec,
                         rows_ws, tickets, enabled, ws, stream):
        self.calls.append(dict(slots=list(slots)[:21 * n], j=list(j)[:n],
                               ints=list(ints), floats=list(floats),
                               rec=list(rec), n_rec=n_rec, rows_ws=rows_ws,
                               tickets=tickets, enabled=enabled, ws=ws))
        return 0


def test_refine_route_argument_block(monkeypatch):
    """icp_refine down the card's route on CPU tensors: one call for the
    window's refining rows, each row's 21 pointers its tensors', the
    record rows ascending, the ints the kernel's; the slots checked again
    only where a row holds other tensors; a row of another shape
    refused."""
    import ctypes
    from goicp_tpu_torch.bounds.error import _slot_tensors
    recorder = _RefineRecorder()
    monkeypatch.setattr(pick, "kernels", recorder)
    monkeypatch.setattr(pick.icp_refine, "launches", 0)
    monkeypatch.setattr(pick, "_stream", lambda x: 0)
    cfg, _, tp, _ = pairs("dynamic trim", pad_cells=64, icp_seeds=4,
                          rot_batch=2)
    _, _, tp_b, _ = pairs("dynamic trim", seed=8, pad_cells=64, icp_seeds=4,
                          rot_batch=2)
    todo = [(j, p, *map(torch.from_numpy, rest))
            for j, p, *rest in _window_todo(tp, tp_b)]
    record = RefineRecord()
    rec = record.rows(3, "cpu")
    rec.ptrs = (ctypes.c_ulonglong * 7)(*(v.data_ptr()
                                          for v in rec.values()))
    pick.icp_refine(cfg, todo[::-1], rec, record)        # any order
    call = recorder.calls[-1]
    assert call["j"] == [0, 2] and call["n_rec"] == 3
    assert call["rec"] == list(rec.ptrs)
    for r, (_, p, R_l, nodes, ubs, cand_R, cand_t) in enumerate(todo):
        want = [x.data_ptr() for x in _slot_tensors(p)] + [
            x.data_ptr() for x in (p.model, R_l, nodes, ubs, cand_R,
                                   cand_t)]
        assert call["slots"][21 * r:21 * (r + 1)] == want, r
    nd, M = tp.n_data_padded, tp.model.shape[0]
    assert call["ints"][:9] == [nd, tp.compat_table.shape[1], 9,
                                tp.data_fpfh.shape[1], 2, 2, nd, nd, 1]
    # K, L, M, max_iter, dynamic trim (mode 3), data_mask and counts read
    assert call["ints"][13:] == [4, 16, M, cfg.icp_max_iter, 3, 1, 1]
    assert call["floats"][4] == pytest.approx(cfg.err_diff)
    assert call["enabled"] is None and call["ws"] is None
    assert pick.icp_refine.launches == 1          # one launch, two rows
    checked = record.args.rechecked
    pick.icp_refine(cfg, todo, rec, record)
    assert record.args.rechecked == checked       # the same tensors
    fresh = [(j, p, R_l.clone(), *rest) for j, p, R_l, *rest in todo]
    pick.icp_refine(cfg, fresh, rec, record)
    assert record.args.rechecked == checked + 2   # R_lanes of each row
    assert recorder.calls[-1]["slots"][16] == fresh[0][2].data_ptr()
    short = [(0, tp, todo[0][2][:8], todo[0][3][:8], todo[0][4][:8],
              *todo[0][5:])]
    with pytest.raises(ValueError, match="R_lanes|shapes"):
        pick.icp_refine(cfg, short + todo[1:], rec, record)
    with pytest.raises(ValueError, match="distinct rows"):
        pick.icp_refine(cfg, [todo[0], todo[0]], rec, record)


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


def test_incumbent_sets_and_their_pointers():
    """The initial routes' outputs (incumbent_tensors: views of one
    buffer): the state's six fields in score_initial_plain's order, their
    shapes and types, contiguous, no two fields overlapping, the PickOut
    pointers the fields' in PickOut's order (0 for the unused bnb), and
    each field writes its own words."""
    want = dict(opt_err=((), torch.float32), opt_R=((3, 3), torch.float32),
                opt_t=((3,), torch.float32), comp=((), torch.int32),
                terms=((3,), torch.float32), last_icp=((), torch.bool))
    sets = [pick.incumbent_tensors("cpu") for _ in range(3)]
    for out, ptrs in sets:
        assert list(out) == list(want)
        assert {k: (tuple(v.shape), v.dtype) for k, v in out.items()} == want
        assert all(v.is_contiguous() for v in out.values())
        assert list(ptrs) == [out[k].data_ptr() if k else 0 for k in (
            "opt_R", "opt_t", "opt_err", "terms", "comp", None, "last_icp")]
        spans = sorted((v.data_ptr(),
                        v.data_ptr() + v.numel() * v.element_size())
                       for v in out.values())
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        for v in out.values():
            v.zero_()
    for i, (out, _) in enumerate(sets):
        out["opt_R"].fill_(i + 1.0)
        out["last_icp"].fill_(True)
    for i, (out, _) in enumerate(sets):
        assert bool((out["opt_R"] == i + 1.0).all())
        assert float(out["opt_err"]) == 0.0 and int(out["comp"]) == 0
        assert bool(out["last_icp"]) and float(out["terms"].abs().sum()) == 0


def test_engines_initialise_on_the_cpu_by_the_plain_route():
    """device_init and fused_init on CPU tensors hold the plain
    composition's incumbent (icp_run_plain, score_initial_plain) and
    launch nothing."""
    from goicp_tpu_torch.bounds import cuda_eval
    from goicp_tpu_torch.search import fused_stream
    cfg, _, tp, _ = pairs("dynamic trim", init_seeds=4, rot_batch=2)
    before = cuda_eval.launch_counts()
    want = pick.initial_incumbent_plain(tp, cfg)
    for st in (pick.initial_incumbent(tp, cfg), teng.device_init(tp, cfg),
               fused_stream.fused_init(tp, cfg)):
        for k, v in want.items():
            assert torch.equal(st[k], v), k
    assert cuda_eval.launch_counts() == before


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


def _card_window(case, **over):
    """(cfg, [row 0, row 1]): two pairs prepared on the card in one shape
    bucket and stacked, as a window's rows (fused_stream._pair_row)."""
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.search import fused_stream as fs
    kw, n, _, dynamic = CASES[case]
    cfg = GoICPConfig(**dict(BASE, **kw, **over))
    raw = [clouds(n, seed=s) for s in (7, 8)]
    dims = [tprep.bucket_dims(c[1], n, len(c[1]), cfg) for c in raw]
    dims = {k: max(d[k] for d in dims) for k in dims[0]}
    ps = [tprep.prepare_pair(*c, cfg, device="cuda", **dims) for c in raw]
    if dynamic:
        ps = [tprep.make_count_dynamic(p) for p in ps]
    pb = stack_pairs(ps)
    return cfg, [fs._pair_row(pb, r) for r in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,case,ubs,how", [
    (1, "l2", "ties", None), (4, "dynamic trim", "ties", None),
    (8, "l2", "inf", None), (12, "dynamic trim", "nan", None),
    (4, "l2", "ties", "disabled"), (4, "dynamic trim", "inf", "workspace"),
    (4, "static trim", "ties", None), (8, "static trim", "nan", None)])
def test_refine_route_equals_compositions_on_the_card(K, case, ubs, how,
                                                      monkeypatch):
    """One launch for a window's two refining rows (row 1 not refining)
    equals the plain composition and the three launches a row, bit for
    bit: K = 1, 4, 8, 12 seeds of 16 lanes; ubs tied, a third inf, a NaN;
    the ICP disabled; the ICP's workspace in device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if how == "workspace":      # every cloud above the shared-memory size
        monkeypatch.setattr(pick, "ICP_SMEM_BYTES", 0)
    cfg, rows = _card_window(case, icp_seeds=K, rot_batch=2)
    todo = []
    for j, p in zip((0, 2), rows):
        R_l, nodes, u = lanes(16, seed=40 + K + j)
        if ubs != "ties":
            u = u.astype(F32) + np.arange(16, dtype=F32) / 64
            u[::3] = np.inf
            if ubs == "nan":
                u[5] = np.nan
        R_l, nodes, u = (torch.from_numpy(x).cuda() for x in (R_l, nodes,
                                                                u))
        todo.append((j, p, R_l, nodes, u, R_l[j + 1].contiguous(),
                     nodes[j + 1, :3] + nodes[j + 1, 3] / 2.0))
    en = torch.tensor(False, device="cuda") if how == "disabled" else None
    before = pick.icp_refine.launches
    got = pick.refine_rows(cfg, todo, 3, "cuda", RefineRecord(), en)
    assert pick.icp_refine.launches == before + 1
    plain = pick.refine_rows_plain(cfg, todo, 3, "cuda", RefineRecord(), en)
    three = pick.refine_rows_by_launches(cfg, todo, 3, "cuda",
                                         RefineRecord(), en)
    assert _same(got.values(), plain.values())
    assert _same(got.values(), three.values())


@pytest.mark.cuda
@pytest.mark.parametrize("K,case,how", [
    (1, "l2", None), (4, "dynamic trim", None), (8, "static trim", None),
    (4, "one block", None), (8, "l2", "workspace")])
def test_initial_route_equals_compositions_on_the_card(K, case, how,
                                                       monkeypatch):
    """The initial incumbent as one launch of the initial route equals the
    plain composition and the two launches it replaced (icp_run,
    score_initial), bit for bit: K = 1, 4, 8 starts; untrimmed, a static
    and a dynamic trim; a cloud of one block (C = 1); the ICP's workspace
    in device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if how == "workspace":      # every cloud above the shared-memory size
        monkeypatch.setattr(pick, "ICP_SMEM_BYTES", 0)
    cfg, pair = _card_pair(case, init_seeds=K)
    before = pick.icp_init.launches
    got = pick.initial_incumbent(pair, cfg)
    assert pick.icp_init.launches == before + 1
    plain = pick.initial_incumbent_plain(pair, cfg)
    two = pick.initial_incumbent_by_launches(pair, cfg)
    keys = ("opt_err", "opt_R", "opt_t", "comp", "terms", "last_icp")
    assert _same([got[k] for k in keys], [plain[k] for k in keys])
    assert _same([got[k] for k in keys], [two[k] for k in keys])
