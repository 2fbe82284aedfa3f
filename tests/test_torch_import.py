"""The PyTorch port imports, prepares and searches (one pair, and a window
of pairs through both cross-pair streams and as one batch) without jax and
without the JAX package, and importing its kernel module neither builds nor needs nvcc.
Its default device is the card: cuda:0, and without a card an error."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "goicp_tpu_torch"

_CHILD = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now raises
    sys.modules["goicp_tpu"] = None    # ... and any import of the JAX package
    import numpy as np
    import torch

    import goicp_tpu_torch
    from goicp_tpu_torch.bounds import cuda_eval
    from goicp_tpu_torch.utils import fp32    # the fixed float32 order
    assert fp32.ordered_sum(torch.ones(40)).item() == 40.0
    assert "goicp_tpu_torch._build" not in sys.modules
    if torch.cuda.is_available():
        assert goicp_tpu_torch.default_device() == torch.device("cuda:0")
    else:
        try:
            goicp_tpu_torch.default_device()
            raise AssertionError("default_device() without a card")
        except RuntimeError as exc:
            assert 'device="cpu"' in str(exc)
    # the user's entry points import too (the host engine, the CLI, the
    # pair runner, the sweeps, the demo, the bench's main, the sweep tool)
    from goicp_tpu_torch import cli
    from goicp_tpu_torch.bench import measure, options
    assert len(options.option_rows()) == 18
    from goicp_tpu_torch.pipeline import demo, device_sweep, pair, sweep
    from goicp_tpu_torch.search import outer
    assert cli.main and measure.main and pair.run_pair and outer.register
    assert sweep.run_sweep and device_sweep.run_sweep_device_batch
    assert demo.run_demo
    # the BO1-scale sweep tool, and the fp32 rows its gates read
    from goicp_tpu_torch.tools import sweep383
    assert sweep383.main and sweep383.run_sweep
    assert len(measure.fp32_rows()) == 96 + 24
    from goicp_tpu_torch.pipeline.prepare import prepare_pair
    from goicp_tpu_torch.search.inner import inner_bnb

    rng = np.random.default_rng(0)
    model = rng.uniform(-0.7, 0.7, size=(40, 3))
    data = model[:32] @ np.diag([1.0, -1.0, -1.0])
    props = rng.integers(0, 9, 40).astype(np.int32)
    cfg = goicp_tpu_torch.GoICPConfig(regularization=0.0005,
                                      distTransSize=10, trans_capacity=32,
                                      trans_pop=4, inner_max_iters=20)
    pair = prepare_pair(data, model, props[:32], props, cfg, pad_data_to=64,
                        device="cpu")
    L = 4
    pts = torch.as_tensor(rng.normal(size=(L, 64, 3)) * 0.4,
                          dtype=torch.float32)
    res = inner_bnb(pair, cfg, pts, torch.full((L,), 0.5),
                    torch.ones(L, dtype=torch.bool), torch.tensor(1e6),
                    with_rot_uncertainty=False, fused=True)
    assert res.best_err.shape == (L,) and res.iters > 0
    assert bool(torch.isfinite(res.best_err).all())

    # the cross-pair stream modules, a few global iterations of each
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.pipeline.prepare import make_count_dynamic
    from goicp_tpu_torch.search import fused_stream, packed_stream
    assert measure._bucket_and_prepare and measure._reassemble
    scfg = goicp_tpu_torch.GoICPConfig(
        regularization=0.0005, distTransSize=10, rot_batch=1,
        trans_capacity=16, trans_pop=2, inner_max_iters=20, icp_max_iter=20,
        device_rot_capacity=64, packed_slots=4)
    window = stack_pairs([make_count_dynamic(
        prepare_pair(data, model, props[:32], props, scfg, pad_data_to=64,
                     device="cpu"))] * 2)
    fstate = fused_stream.fused_run_chunk(
        window, scfg, fused_stream._init_batch(window, scfg), 3)
    assert min(fstate["it"].tolist()) >= 1
    pstate = packed_stream.packed_run_chunk(
        window, scfg, packed_stream.packed_init(window, scfg), 3)
    assert min(pstate["it"].tolist()) >= 1
    assert 2 <= fused_stream.counters["global_iters"] <= 6

    # the batch engines (two outer steps of the window as one batch) and
    # the helpers off the search path
    from goicp_tpu_torch.chem import extras
    from goicp_tpu_torch.pipeline import visualize
    from goicp_tpu_torch.search import chunked, device_engine
    from goicp_tpu_torch.utils import profiling
    bstate = device_engine.batch_run_chunk(
        window, scfg, device_engine.batch_init(window, scfg), 2)
    assert bstate["it"].tolist() == [2, 2]
    assert chunked.register_device_batch_compact and chunked.load_state
    assert extras.property_density and visualize.plot_registration
    assert profiling.PhaseTimers and profiling.trace
    # the multi-GPU modules (they need a process group to run)
    from goicp_tpu_torch.dist import dryrun, mesh, spawn
    from goicp_tpu_torch.search import sharded_engine
    assert mesh.init_distributed and mesh.make_mesh and mesh.put_global
    assert mesh.sharded_inner_step and mesh.reduce_best
    assert sharded_engine.register_device_sharded and spawn.run_ranks
    assert dryrun.dryrun_multichip
    assert sys.modules["jax"] is None and sys.modules["goicp_tpu"] is None
    assert not [m for m in sys.modules
                if m.startswith(("jax.", "goicp_tpu."))]
    assert "goicp_tpu_torch._build" not in sys.modules
    print("OK")
""")


def test_port_runs_without_jax_or_nvcc():
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),  # no nvcc
               CUDA_HOME=str(REPO / "no-cuda-here"), PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


@pytest.mark.cuda
def test_default_device_is_the_first_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import goicp_tpu_torch
    assert goicp_tpu_torch.default_device() == torch.device("cuda:0")


def test_no_module_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|goicp_tpu)\b", re.M)
    offenders = [str(p.relative_to(REPO))
                 for p in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]
                 if pattern.search(p.read_text())]
    assert offenders == []
