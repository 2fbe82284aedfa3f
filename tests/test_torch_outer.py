"""The port's host-streaming engine (goicp_tpu_torch/search/outer.py) vs the
JAX package's: the native batched heap pop for pop against both Python
heaps, `register` on the same prepared pair (fused and two-pass inner
search), checkpoints, and the refusals (dynamic counts, a failed native
build)."""

import dataclasses

import numpy as np
import pytest
import torch

from goicp_tpu.config import GoICPConfig as JConfig
from goicp_tpu.pipeline.prepare import prepare_pair as jprepare
from goicp_tpu.search import outer as jouter
from goicp_tpu_torch import _build, native
from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.pipeline.prepare import make_count_dynamic, prepare_pair
from goicp_tpu_torch.search import outer as touter
from tests.test_search import _FAST, _synth

torch.set_num_threads(1)


def _heap_ops(seed):
    """Pushes with many equal lbs, and pops at incumbents that discard
    stale nodes."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(12):
        n = int(rng.integers(1, 30))
        lb = rng.integers(0, 6, n).astype(np.float32) * np.float32(0.5)
        cols = [rng.normal(size=n).astype(np.float32) for _ in range(4)]
        ops.append(("push", (lb, *cols, rng.integers(0, 9, n).astype(
            np.int32), lb + np.float32(1.0))))
        ops.append(("pop", (int(rng.integers(1, 9)),
                            float(rng.choice([np.inf, 2.0, 2.75])))))
    return ops


@pytest.mark.parametrize("capacity", [0, 1, 17])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_heap_pops_like_both_python_heaps(capacity, seed):
    heaps = [touter.make_frontier(capacity), touter.PyFrontier(capacity),
             jouter.PyFrontier(capacity)]
    assert isinstance(heaps[0], native.NativeFrontier)
    for op, args in _heap_ops(seed):
        outs = [getattr(h, op)(*args) for h in heaps]
        if op == "pop":
            for got in outs[:2]:
                for a, b in zip(got, outs[2]):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
        assert len({len(h) for h in heaps}) == 1
        assert len({h.min_lb for h in heaps}) == 1
        assert len({h.min_dropped_lb for h in heaps}) == 1
    if capacity:
        assert np.isfinite(heaps[0].min_dropped_lb)
    for h in heaps:
        h.clear()
    assert [len(h) for h in heaps] == [0, 0, 0]
    assert heaps[0].min_lb == heaps[2].min_lb == np.inf


@pytest.mark.parametrize("fused_inner", [1, 0])
def test_register_matches_jax(fused_inner):
    data, model, props, R, tv = _synth(60, 1)
    jcfg = JConfig(**_FAST, fused_inner=fused_inner)
    cfg = GoICPConfig(**_FAST, fused_inner=fused_inner)
    jp = jprepare(data, model, props, props, jcfg)
    want = jouter.register(jp, jcfg)
    # the port's own preparation (held equal to JAX's in
    # test_torch_prepare.py)
    pair = prepare_pair(data, model, props, props, cfg, device="cpu")
    got = touter.register(pair, cfg)
    assert abs(got.error - want.error) <= 1e-5
    np.testing.assert_allclose(got.R, want.R, atol=1e-4)
    np.testing.assert_allclose(got.t, want.t, atol=1e-4)
    for k in ("outer_steps", "bound_evals", "icp_runs", "converged",
              "optComp", "compatibilities", "last_icp"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.converged and got.gap <= cfg.MSEThresh * pair.inlier_num
    np.testing.assert_allclose(got.R, R, atol=1e-4)
    np.testing.assert_allclose(got.t, tv, atol=1e-4)


def test_checkpointed_run_resumes_to_the_same_result(tmp_path):
    data, model, props, *_ = _synth(60, 1)
    cfg = GoICPConfig(**_FAST)
    pair = prepare_pair(data, model, props, props, cfg, device="cpu")
    whole = touter.register(pair, cfg)
    ck = str(tmp_path / "search.npz")
    stopped = touter.register(
        pair, dataclasses.replace(cfg, max_outer_steps=5),
        checkpoint_path=ck, checkpoint_every=2)
    assert stopped.outer_steps == 5 and not stopped.converged
    assert (tmp_path / "search.npz").exists()
    resumed = touter.register(pair, cfg, checkpoint_path=ck)
    assert not (tmp_path / "search.npz").exists()   # finished: removed
    assert resumed.converged == whole.converged is True
    assert resumed.outer_steps == whole.outer_steps > 5
    assert resumed.error == whole.error
    np.testing.assert_array_equal(resumed.R, whole.R)
    np.testing.assert_array_equal(resumed.t, whole.t)


def test_checkpoint_without_npz_suffix_resumes(tmp_path):
    """A checkpoint_path without `.npz` is the file written and the file
    resumed (np.savez alone would write `search.ckpt.npz` and the resume
    would start over)."""
    data, model, props, *_ = _synth(60, 1)
    cfg = GoICPConfig(**_FAST)
    pair = prepare_pair(data, model, props, props, cfg, device="cpu")
    whole = touter.register(pair, cfg)
    ck = tmp_path / "search.ckpt"
    stopped = touter.register(
        pair, dataclasses.replace(cfg, max_outer_steps=5),
        checkpoint_path=str(ck), checkpoint_every=2)
    assert stopped.outer_steps == 5 and not stopped.converged
    assert [p.name for p in tmp_path.iterdir()] == ["search.ckpt"]
    resumed = touter.register(pair, cfg, checkpoint_path=str(ck))
    assert not ck.exists()                          # finished: removed
    assert resumed.converged == whole.converged is True
    assert resumed.outer_steps == whole.outer_steps > 5
    assert resumed.error == whole.error
    assert resumed.optComp == whole.optComp
    np.testing.assert_array_equal(resumed.R, whole.R)
    np.testing.assert_array_equal(resumed.t, whole.t)


def test_checkpoint_file_matches_jax_format(tmp_path):
    heaps = (touter.make_frontier(0), jouter.PyFrontier(0))
    for h in heaps:
        for _, args in _heap_ops(3)[:1]:
            h.push(*args)
    state = dict(error=np.float64(5.0), R=np.eye(3), t=np.zeros(3), comp=7,
                 last_icp=True, steps=42)
    touter.save_checkpoint(str(tmp_path / "t.npz"), heaps[0], state)
    jouter.save_checkpoint(str(tmp_path / "j.npz"), heaps[1], state)
    (tn, topt), (jn, jopt) = (touter.load_checkpoint(str(tmp_path / "t.npz")),
                              jouter.load_checkpoint(str(tmp_path / "j.npz")))
    for a, b in zip(tn, jn):
        np.testing.assert_array_equal(a, b)
    assert topt.keys() == jopt.keys()
    assert len(heaps[0]) == len(heaps[1]) > 0      # drained and re-pushed


def test_register_refuses_dynamic_counts():
    data, model, props, *_ = _synth(24, 2)
    cfg = GoICPConfig(**_FAST)
    pair = make_count_dynamic(prepare_pair(data, model, props, props, cfg,
                                           pad_data_to=32, device="cpu"))
    with pytest.raises(ValueError, match="static counts"):
        touter.register(pair, cfg)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No fallback: without a compiler the heap (and the .mol2 reader)
    raise instead of running Python code in its place."""
    from goicp_tpu_torch.io.mol2 import read_mol_file
    monkeypatch.setattr(_build, "_host_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
            touter.make_frontier(0)
        with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
            read_mol_file(str(tmp_path / "any.mol2"))
    finally:
        native._lib.cache_clear()
