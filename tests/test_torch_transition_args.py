"""The transition's host path (goicp_tpu_torch/search/transition.py): the
argument blocks (TransitionArgs) that hold a call site's checked slots,
and the run's output sets used in turn (TransitionBuffers).

The kernel's route needs a card, so the block tests drive harvest and
advance down that route on CPU tensors with the C functions replaced by a
recorder (route, kernels and the stream handle monkeypatched): the slots
are checked, packed and handed over exactly as on the card.  The engine
tests run register_device and the batch engine on the CPU, where the
transition takes harvest_plain / advance_plain through the same output
sets, and hold them to the JAX package's rows of the same bench pairs
(goicp_tpu_torch/bench/reference_rows.jsonl, written by the JAX package:
counters and error exactly)."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from goicp_tpu_torch import GoICPConfig
from goicp_tpu_torch.bench.measure import (_bucket_and_prepare,
                                           _normalized_synthetic,
                                           bench_shape, synthetic_pool)
from goicp_tpu_torch.dist.mesh import stack_pairs
from goicp_tpu_torch.search import device_engine as eng
from goicp_tpu_torch.search import fused_stream as fs
from goicp_tpu_torch.search import transition as tr

# small torch ops in a loop: intra-op threads only contend with the
# parallel test workers (see test_torch_device_engine.py)
torch.set_num_threads(1)

ROWS = pathlib.Path(__file__).resolve().parents[1] / "goicp_tpu_torch" \
    / "bench" / "reference_rows.jsonl"
F32 = torch.float32


@pytest.fixture(scope="module")
def bench():
    """The bench configuration and syn00 / syn05 prepared on the CPU in
    one shape bucket (4 and 3 outer steps)."""
    cfg = bench_shape(GoICPConfig())
    pool = {e[0]: e for e in synthetic_pool(6, seed=7)}
    names = ("syn00", "syn05")
    return cfg, dict(zip(names, _bucket_and_prepare(
        [_normalized_synthetic(pool[n]) for n in names], cfg,
        device="cpu")))


def _row(name: str) -> dict:
    with open(ROWS) as fh:
        return next(r for r in map(json.loads, fh) if r["pair"] == name)


def _result_row(r) -> dict:
    return dict(error=float(r.error), converged=bool(r.converged),
                outer=int(r.outer_iters), inner=int(r.inner_iters),
                evals=int(r.evals), icp_runs=int(r.icp_runs))


class _Recorder:
    """The C functions' stand-in: records each call's pointer slots."""

    def __init__(self):
        self.calls = []

    def goicp_harvest(self, slots, n_slots, ints, n_ints, rows, n, stream):
        self.calls.append(("harvest", list(slots), list(rows)[:n]))
        return 0

    def goicp_advance(self, slots, n_slots, ints, n_ints, root, rows,
                      out_rows, n, stream):
        self.calls.append(("advance", list(slots), list(rows)[:n]))
        return 0


@pytest.fixture
def kernel_route(monkeypatch):
    """harvest and advance down the kernel's route on CPU tensors."""
    rec = _Recorder()
    monkeypatch.setattr(tr, "kernels", rec)
    monkeypatch.setattr(tr, "route", lambda cfg, x: "kernel")
    monkeypatch.setattr(tr, "_stream", lambda x: 0)
    return rec


@pytest.fixture(scope="module")
def window(bench):
    """A window of syn00 + syn05 after 3 global iterations of the fused
    stream on the CPU, and its transition tables."""
    cfg, pairs = bench
    pb = stack_pairs([pairs["syn00"], pairs["syn05"]])
    s = fs.fused_run_chunk(pb, cfg, fs._init_batch(pb, cfg), 3)
    return cfg, pb, s, fs._transition_tables(pb, cfg)


def _slot(name: str) -> int:
    return tr._HARVEST_IN.index(name)


def test_block_reused_for_the_same_tensors_and_rebuilt_for_a_new_one(
        window, kernel_route):
    cfg, pb, s, tabs = window
    s = fs._map_state(torch.clone, s)
    bufs = tr.TransitionBuffers()
    rows = [0, 1]
    for _ in range(4):          # both output sets, twice each
        h = tr.harvest(cfg, s, rows, bufs=bufs)
    blocks = list(bufs.blocks.values())
    assert len(blocks) == 2 and all(b.rechecked == 0 for b in blocks)
    first = kernel_route.calls[0][1]
    assert kernel_route.calls[2][1] == first          # same set, same block
    assert kernel_route.calls[1][1] != first          # the other set
    # a replaced tensor: its slot re-checked and repointed, the rest kept
    s["opt_err"] = s["opt_err"].clone()
    tr.harvest(cfg, s, rows, bufs=bufs)
    tr.harvest(cfg, s, rows, bufs=bufs)
    rechecked = sorted(b.rechecked for b in bufs.blocks.values())
    assert rechecked == [1, 1], rechecked
    slots = kernel_route.calls[-1][1]
    assert slots[_slot("opt_err")] == s["opt_err"].data_ptr()
    assert slots[_slot("opt_err")] != first[_slot("opt_err")]
    assert [c for i, c in enumerate(slots) if i != _slot("opt_err")] == \
        [c for i, c in enumerate(kernel_route.calls[-3][1])
         if i != _slot("opt_err")]
    # the advance in place (the fused stream's call), reused likewise
    for _ in range(3):
        tr.advance("both", cfg, pb, s, rows, tables=tabs, h=h, out=s,
                   bufs=bufs)
    adv = [c for c in kernel_route.calls if c[0] == "advance"]
    assert adv[0][1] == adv[1][1] == adv[2][1]
    assert adv[0][1][len(tr._ADV_ROWS) + len(tr._ADV_SERVED)
                    + len(tr._ADV_PAIRS)] == s["fr_nodes"].data_ptr()
    assert h["lb_safe"].shape == (2, cfg.rot_batch * 8)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device",
                                 "non-contiguous output"])
def test_block_raises_naming_the_slot(window, kernel_route, bad):
    cfg, pb, s, tabs = window
    s = fs._map_state(torch.clone, s)
    rows = [0, 1]
    bufs = tr.TransitionBuffers()
    if bad == "non-contiguous output":
        h = tr.harvest(cfg, s, rows, bufs=bufs)
        out = fs._map_state(torch.clone, s)
        out["opt_R"] = out["opt_R"].transpose(1, 2)
        with pytest.raises(ValueError, match="o_opt_R.*not contiguous"):
            tr.advance("both", cfg, pb, s, rows, tables=tabs, h=h, out=out,
                       bufs=bufs)
        return
    tr.harvest(cfg, s, rows, bufs=bufs)         # a block to re-check
    # (the device the slots must share is opt_err's)
    slot = "R_lanes" if bad == "device" else "opt_err"
    x = s[slot]
    s[slot] = dict(dtype=x.double(), shape=x[:1],
                   device=torch.empty_like(x, device="meta"))[bad]
    with pytest.raises(ValueError, match=f"transition: {slot} must be"):
        tr.harvest(cfg, s, rows, bufs=bufs)
    with pytest.raises(ValueError, match=f"transition: {slot} must be"):
        tr.harvest(cfg, s, rows)                # a block built for the call


def test_sets_in_turn_never_hold_the_inputs():
    bufs = tr.TransitionBuffers()
    made = []

    def alloc():
        made.append(dict(x=torch.zeros(4)))
        return made[-1]
    def took(*inputs):
        idx, out = bufs.take("k", alloc, inputs)
        return idx, next((n for n, s in zip("ab", made) if s is out), out)
    assert took() == (0, "a") and took() == (1, "b")
    a, b = made
    assert took() == (0, "a") and took() == (1, "b")
    # the set in turn holds an input (a view of it): the other one
    assert took(a["x"][1:]) == (1, "b")
    assert took(b["x"]) == (0, "a")
    # both hold inputs: a new set, kept by neither turn
    idx, c = took(a["x"], b["x"][:2])
    assert idx is None and c is made[2] and len(made) == 3
    assert took() in ((0, "a"), (1, "b"))


def test_register_device_alternates_its_sets_and_matches_jax_rows(bench):
    cfg, pairs = bench
    pair = pairs["syn00"]
    body = eng._make_body(pair, cfg)
    s = eng.device_init(pair, cfg)
    seen = []
    for _ in range(3):
        s, _ = body(s)
        seen.append(s["fr_lbs"].untyped_storage().data_ptr())
    # a step writes into the set its state does not lie in; the state
    # before the last stays valid until the step after next
    assert seen[0] != seen[1] and seen[2] == seen[0]
    got = _result_row(eng.register_device(pair, cfg))
    assert got == {k: v for k, v in _row("syn00").items() if k != "pair"}


def test_batch_engine_with_sets_matches_jax_rows(bench):
    cfg, pairs = bench
    res = eng.register_device_batch([pairs["syn00"], pairs["syn05"]], cfg)
    for j, name in enumerate(("syn00", "syn05")):
        got = _result_row(eng.DeviceResult(*(np.asarray(v)[j]
                                              for v in res)))
        assert got == {k: v for k, v in _row(name).items() if k != "pair"}


def test_outputs_start_on_16_bytes_and_odd_frontiers_take_the_torch_code(
        bench):
    # goicp_advance stages and writes a frontier row with bulk copies,
    # which need 16-byte aligned rows: every packed output field starts
    # on 16 bytes, and a capacity that is not a multiple of 4 is left to
    # the torch code
    cfg, pairs = bench
    nd = pairs["syn00"].n_data_padded
    for mode in ("pop", "adopt", "both"):
        for n in (1, 3):
            out = tr.outputs(mode, cfg, n, nd, "cpu")
            assert all(x.data_ptr() % 16 == 0 for x in tr._leaves(out)), \
                (mode, n)
    assert tr.kernel_carries(cfg) and cfg.device_rot_capacity % 4 == 0
    odd = dataclasses.replace(cfg, device_rot_capacity=130)
    assert not tr.kernel_carries(odd)
    assert tr.route(odd, torch.empty(0)) == "plain"
