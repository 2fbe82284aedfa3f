"""The rules csrc/inner.cu's goicp_inner_run is built on, held on the CPU
to the plain loops (goicp_tpu_torch/search/inner.py::inner_run_plain):

  * the counters formed once, after the run, from each lane's own records
    (its steps, evaluations and geometric survivors, each lane stepped
    alone until it is done or its group's it reaches inner_max_iters):
    the rule written once here in numpy (_kernel_counters, the kernel's
    run_finish) equals inner_run_plain's counters and iteration count in
    modes search (with and without lane_compaction, lanes done from the
    start) and groups (counters given, a group capped by
    inner_max_iters);
  * the merge by rank search (inner_body.cuh::lane_tail): the children
    ranked among themselves, each entry's rank in the other list by binary
    search, modelled here in numpy (_merge_order), gives
    torch.argsort(stable=True)'s order of the concatenated keys under both
    sorted_merge settings, with ties between the frontier and the
    children, +-inf, NaN and an all-pruned batch;
  * inner_run's argument block (search/args.py TransitionArgs, the
    transition's): down the kernel's route on CPU tensors, with the C
    function replaced by a recorder, a block is kept for each output set
    and re-checks only the slots that hold a new tensor, and a wrong slot
    raises, naming it.
"""

import numpy as np
import pytest
import torch

from goicp_tpu_torch import config as tconfig
from goicp_tpu_torch.bounds import cuda_eval
from goicp_tpu_torch.bounds.evaluate import rot_uncertainty
from goicp_tpu_torch.search import inner as tinner
from goicp_tpu_torch.search.args import TransitionBuffers

# small torch ops in a loop: intra-op threads only contend with the
# parallel test workers (see test_torch_device_engine.py)
torch.set_num_threads(1)

INC = 40.0
BASE = {"MSEThresh": 0.01, "regularization": 0.0005, "ponderation": 1,
        "distTransSize": 12, "trans_capacity": 64, "trans_pop": 4,
        "inner_max_iters": 200, "chem_reuse": 1, "lane_compaction": 1}


def _case(seed=3, active=(1, 1, 0, 1, 1, 1, 0, 1), **over):
    """A pair prepared by the port on the CPU, 8 rotated lanes, their
    rotation uncertainty and initial lanes (`active` 0: done from the
    start)."""
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    from goicp_tpu_torch.pipeline.prepare import prepare_pair
    cfg = tconfig.GoICPConfig(**{**BASE, **over})
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-0.8, 0.8, size=(48, 3))
    src = (tgt[:40] - 0.05) @ rodrigues_np(rng.uniform(-1, 1, 3)).T
    props = rng.integers(0, 9, size=48).astype(np.int32)
    pair = prepare_pair(src, tgt, props[:40], props, cfg, pad_data_to=64,
                        device="cpu")
    rots = np.stack([rodrigues_np(v) for v in rng.uniform(-2, 2, (8, 3))])
    pts = torch.as_tensor(np.einsum("lij,nj->lni", rots, pair.data.numpy()),
                          dtype=torch.float32).contiguous()
    mrd = rot_uncertainty(torch.as_tensor(rng.uniform(0.2, 1.2, 8),
                                          dtype=torch.float32),
                          pair.norm_data)
    lanes = tinner.initial_lanes(pair, cfg, pts, torch.as_tensor(
        np.asarray(active, bool)), torch.tensor(INC))
    return cfg, pair, pts, mrd, lanes


def _lane_records(pair, cfg, lanes, pts, mrd, caps):
    """Each lane stepped alone (a batch of one), as a cluster of the
    kernel iterates it: while its flag is clear and it made fewer than
    caps[l] steps.  -> steps, final done, evals, survivors (numpy, per
    lane) and the chem corners of one lane's step."""
    L = pts.shape[0]
    steps, done, ev, su = (np.zeros(L, np.int64) for _ in range(4))
    per_lane = 0
    for l in range(L):
        s = {k: v[l:l + 1] for k, v in lanes.items()}
        while steps[l] < caps[l] and not bool(s["done"][0]):
            s, _, st = tinner.inner_step_plain(pair, cfg, s, pts[l:l + 1],
                                               mrd[l:l + 1], True)
            steps[l] += 1
            ev[l] += int(st.evals[0])
            su[l] += int(st.geom_surv[0])
            per_lane = st.corners_per_lane
        done[l] = bool(s["done"][0])
    return steps, done, ev, su, per_lane


def _kernel_counters(mode, steps, done, ev, su, G, Q, w1=0, w2=0,
                     cnt_in=None):
    """run_finish's rule: each group's it the most steps of its lanes,
    evals and survivors their sums, chem_corners it x G x Q, or in mode
    search Q x the widths of the staged compaction's stages, from each
    lane's last iteration e (steps - 1 where it ended done, it - 1 where
    it ran to the cap): the iterations wider than w are the largest
    e_m + 1 with more than w lanes' e >= e_m.  -> counters (4, groups),
    iterations."""
    L = len(steps)
    groups = L // G
    cnt = np.zeros((4, groups), np.int64) if cnt_in is None \
        else np.array(cnt_in, np.int64)
    S = steps.reshape(groups, G).max(axis=1)
    cnt[0] += S
    cnt[1] += ev.reshape(groups, G).sum(axis=1)
    cnt[2] += su.reshape(groups, G).sum(axis=1)
    it = int(S.max()) if groups else 0
    if mode == "search":
        e = np.where(done, steps - 1, it - 1)

        def wider(w):
            c = np.array([(e >= em).sum() for em in e])
            return int(max([em + 1 for em, cm in zip(e, c) if cm > w],
                           default=0))
        t1 = wider(w1) if w1 > 0 else it
        t2 = wider(w2) if w2 > 0 else it
        cnt[3] += Q * (L * t1 + w1 * (t2 - t1) + w2 * (it - t2))
    else:
        cnt[3] += S * G * Q
    return cnt, it


@pytest.mark.parametrize("compaction,active", [
    (1, (1, 1, 0, 1, 1, 1, 0, 1)),
    (0, (1, 1, 0, 1, 1, 1, 0, 1)),
    (1, (1, 0, 0, 0, 1, 0, 0, 0)),
])
def test_search_counters_from_lane_records(compaction, active):
    cfg, pair, pts, mrd, lanes = _case(lane_compaction=compaction,
                                       active=active)
    want = tinner.inner_run_plain(pair, cfg, lanes, pts, mrd, True, "search")
    steps, done, ev, su, per_lane = _lane_records(
        pair, cfg, lanes, pts, mrd, [cfg.inner_max_iters] * 8)
    widths = tinner._stage_widths(cfg, 8) + [0, 0]
    cnt, it = _kernel_counters("search", steps, done, ev, su, 8, per_lane,
                               widths[1], widths[2])
    assert it == want.iters > 0
    got = np.stack([want.counters[k].numpy()
                    for k in tinner._COUNTERS])
    np.testing.assert_array_equal(cnt, got)
    # lanes end at different steps, those done from the start at 0
    assert len(set(steps.tolist())) > 1 and (steps == 0).sum() \
        == (np.asarray(active) == 0).sum()
    np.testing.assert_array_equal(done, want.lanes["done"].numpy())


def test_groups_counters_from_lane_records():
    cfg, pair, pts, mrd, lanes = _case()
    it_in = [3, cfg.inner_max_iters - 4]     # the second group capped
    counters = {k: torch.tensor([v, v + 1], dtype=torch.int32)
                for k, v in zip(tinner._COUNTERS, (0, 11, 7, 5))}
    counters["it"] = torch.tensor(it_in, dtype=torch.int32)
    want = tinner.inner_run_plain(pair, cfg, lanes, pts, mrd, True,
                                  "groups", groups=2, counters=counters)
    caps = [cfg.inner_max_iters - it_in[l // 4] for l in range(8)]
    steps, done, ev, su, per_lane = _lane_records(pair, cfg, lanes, pts,
                                                  mrd, caps)
    cin = np.stack([counters[k].numpy() for k in tinner._COUNTERS])
    cnt, it = _kernel_counters("groups", steps, done, ev, su, 4, per_lane,
                               cnt_in=cin)
    assert it == want.iters
    got = np.stack([want.counters[k].numpy() for k in tinner._COUNTERS])
    np.testing.assert_array_equal(cnt, got)
    assert steps[4:].max() == 4 and not done[4:].all()


# ---------------------------------------------------------------------------
# the merge by rank search
# ---------------------------------------------------------------------------

def _key_order(v) -> int:
    """inner_body.cuh's key_order: a float key as an unsigned integer of
    the merge's order (the zeros equal, every NaN equal and last)."""
    if np.isnan(v):
        return 0xFFFFFFFF
    u = int(np.float32(0.0 if v == 0 else v).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000


def test_key_order_keeps_the_merge_order():
    vals = np.array([-np.inf, -3.5, -1e-40, -0.0, 0.0, 1e-40, 2.0, 3e38,
                     np.inf], np.float32)
    ords = [_key_order(v) for v in vals]
    assert ords == sorted(ords) and ords[3] == ords[4]
    assert len(set(ords)) == len(vals) - 1
    nans = np.array([np.nan, -np.nan], np.float32)
    nans[1] = np.float32(np.frombuffer(np.uint32(0xFFC00001).tobytes(),
                                       np.float32)[0])
    assert {_key_order(v) for v in nans} == {0xFFFFFFFF}
    assert 0xFFFFFFFF > ords[-1]


def _merge_order(rest, children, sorted_merge):
    """lane_tail's merge in numpy: the concatenation's entries (rest
    first) in output order.  The rest must be in the merge's order."""
    nan_last = not sorted_merge

    def key(v):
        return v if nan_last or not np.isnan(v) else np.inf

    def less(a, b):
        return a < b or (nan_last and np.isnan(b) and not np.isnan(a))

    R, B = len(rest), len(children)
    kr = [key(v) for v in rest]
    kc = [key(v) for v in children]
    assert not any(less(kr[r + 1], kr[r]) for r in range(R - 1))
    # the children ranked among themselves by their integer keys
    ords = [_key_order(v) for v in kc]
    skey, corder = [None] * B, [None] * B
    for j in range(B):
        m = sum(ords[f] < ords[j] or (ords[f] == ords[j] and f < j)
                for f in range(B))
        skey[m], corder[m] = kc[j], j

    def count_before(arr, x):         # binary search, as the kernel's
        lo, hi = 0, len(arr)
        while lo < hi:
            mid = (lo + hi) // 2
            if less(arr[mid], x):
                lo = mid + 1
            else:
                hi = mid
        return lo

    def count_not_after(arr, x):
        lo, hi = 0, len(arr)
        while lo < hi:
            mid = (lo + hi) // 2
            if not less(x, arr[mid]):
                lo = mid + 1
            else:
                hi = mid
        return lo

    out = [None] * (R + B)
    for r in range(R):
        out[r + count_before(skey, kr[r])] = r
    for m in range(B):
        out[m + count_not_after(kr, skey[m])] = R + corder[m]
    return out


def _merge_case(rng, sorted_merge, all_pruned=False):
    """A sorted rest and a batch of children drawn from a few values, so
    that keys tie across both lists, with -inf, +inf and NaN."""
    vals = np.array([-np.inf, 0.5, 1.0, 1.0, 2.0, np.inf, np.nan],
                    np.float32)
    rest = rng.choice(vals, size=40).astype(np.float32)
    nan_last = not sorted_merge
    k = np.where(np.isnan(rest) & (not nan_last), np.inf, rest)
    rest = rest[np.argsort(k, kind="stable")]
    children = np.full(32, np.inf, np.float32) if all_pruned \
        else rng.choice(vals, size=32).astype(np.float32)
    return rest, children


@pytest.mark.parametrize("sorted_merge", [0, 1])
@pytest.mark.parametrize("all_pruned", [False, True])
def test_merge_by_rank_search_is_the_stable_argsort(sorted_merge,
                                                    all_pruned):
    rng = np.random.default_rng(11 + sorted_merge)
    for _ in range(20):
        rest, children = _merge_case(rng, sorted_merge, all_pruned)
        keys = torch.as_tensor(np.concatenate([rest, children]))
        if sorted_merge:
            keys = torch.where(torch.isnan(keys), torch.inf, keys)
        want = torch.argsort(keys, stable=True).tolist()
        assert _merge_order(rest, children, sorted_merge) == want


def test_merge_by_rank_search_equals_the_kept_merge():
    """Under sorted_merge 1 the order is _merge_sorted_keep's (the torch
    body's), which keeps a NaN's value where it ranks as +inf."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        rest, children = _merge_case(rng, 1)
        order = _merge_order(rest, children, 1)
        both = np.concatenate([rest, children])
        nodes = torch.arange(len(both), dtype=torch.float32)
        kl, kn, dropped = tinner._merge_sorted_keep(
            torch.as_tensor(rest)[None], nodes[None, :40, None],
            torch.as_tensor(children)[None], nodes[None, 40:, None], 48)
        assert kn[0, :, 0].long().tolist() == order[:48]
        np.testing.assert_array_equal(kl[0].numpy(), both[order[:48]])
        np.testing.assert_array_equal(dropped[0].numpy(), both[order[48:]])


# ---------------------------------------------------------------------------
# the argument block
# ---------------------------------------------------------------------------

class _Recorder:
    """goicp_inner_run's stand-in: records each call's slots and ints."""

    def __init__(self):
        self.calls = []

    def goicp_inner_run(self, slots, n_slots, ints, n_ints, reg, stream):
        self.calls.append((list(slots)[:n_slots], list(ints)[:n_ints]))
        return 0


@pytest.fixture
def kernel_route(monkeypatch):
    """inner_run down the kernel's route on CPU tensors."""
    rec = _Recorder()
    monkeypatch.setattr(tinner, "kernels", rec)
    monkeypatch.setattr(cuda_eval, "_route", lambda x: "cuda")
    monkeypatch.setattr(tinner, "_stream", lambda x: 0)
    return rec


def _slot(name: str) -> int:
    names = [s[0] for s in tinner._run_specs(8, 64, 64, 1, 12, 1, 1, 48)]
    return names.index(name)


def test_block_kept_a_set_and_rechecked_where_a_tensor_changed(
        kernel_route):
    cfg, pair, pts, mrd, lanes = _case()
    bufs = TransitionBuffers()
    outs = [tinner.inner_run(pair, cfg, lanes, pts, mrd, True, "search",
                             bufs=bufs) for _ in range(4)]
    calls = kernel_route.calls
    assert len(calls[0][0]) == 47 and len(calls[0][1]) == 17
    blocks = list(bufs.blocks.values())
    assert len(blocks) == 2 and all(b.rechecked == 0 for b in blocks)
    assert calls[2][0] == calls[0][0] and calls[1][0] != calls[0][0]
    assert outs[2].lanes["lbs"].data_ptr() == outs[0].lanes["lbs"].data_ptr()
    # a set's int words start zero (the kernel leaves its sync words so)
    assert int(outs[0].iters) == int(outs[1].clusters) == 0
    # a replaced tensor: its slot re-checked and repointed, the rest kept
    lanes = dict(lanes, opt_err=lanes["opt_err"].clone())
    for _ in range(2):
        tinner.inner_run(pair, cfg, lanes, pts, mrd, True, "search",
                         bufs=bufs)
    assert sorted(b.rechecked for b in bufs.blocks.values()) == [1, 1]
    slots = calls[-1][0]
    assert slots[_slot("opt_err")] == lanes["opt_err"].data_ptr()
    assert [c for i, c in enumerate(slots) if i != _slot("opt_err")] == \
        [c for i, c in enumerate(calls[-3][0]) if i != _slot("opt_err")]
    # another mode: its own blocks, its ints
    tinner.inner_run(pair, cfg, lanes, pts, mrd, True, "stream", steps=7,
                     groups=2)
    assert calls[-1][1][12:15] == [2, cfg.inner_max_iters, 7]


def test_block_kept_as_a_streams_steps_change(kernel_route):
    # the fused stream calls with the steps left to its chunk: one block
    # a set, its ints written each call, not a block a steps value
    cfg, pair, pts, mrd, lanes = _case()
    bufs = TransitionBuffers()
    for steps in (9, 8, 7, 6):
        tinner.inner_run(pair, cfg, lanes, pts, mrd, True, "stream",
                         steps=steps, groups=2, bufs=bufs)
        assert kernel_route.calls[-1][1][14] == steps
    assert len(bufs.blocks) == 2
    assert kernel_route.calls[2][0] == kernel_route.calls[0][0]
    tinner.inner_run(pair, cfg, lanes, pts, mrd, True, "groups", groups=2,
                     bufs=bufs)
    assert len(bufs.blocks) == 2
    assert kernel_route.calls[-1][1][12] == tinner._RUN_MODES["groups"]


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_block_raises_naming_the_slot(kernel_route, bad):
    cfg, pair, pts, mrd, lanes = _case()
    bufs = TransitionBuffers()
    tinner.inner_run(pair, cfg, lanes, pts, mrd, True, "search", bufs=bufs)
    slot = "best_node" if bad == "shape" else "thr"
    x = lanes[slot]
    wrong = dict(dtype=lambda: x.double(),
                 shape=lambda: x[:, :3].contiguous(),
                 device=lambda: torch.empty_like(x, device="meta"))[bad]()
    bad_lanes = dict(lanes, **{slot: wrong})
    with pytest.raises(ValueError, match=f"inner_run: {slot} must be"):
        tinner.inner_run(pair, cfg, bad_lanes, pts, mrd, True, "search",
                         bufs=bufs)
    with pytest.raises(ValueError, match=f"inner_run: {slot} must be"):
        tinner.inner_run(pair, cfg, bad_lanes, pts, mrd, True, "search")
