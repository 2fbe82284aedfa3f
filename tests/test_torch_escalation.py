"""Frontier-capacity escalation in the port's fused stream
(goicp_tpu_torch/search/fused_stream.py): migrate_row_capacity vs the JAX
package's on the same stream state, the escalated stream vs the plain one
(converged, error within MSEThresh * Nd + 1e-5), and the configurations it
refuses."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from goicp_tpu.dist.mesh import stack_pairs as jstack_pairs
from goicp_tpu.search import fused_stream as jfs
from goicp_tpu_torch.pipeline.prepare import pair_from_jax
from goicp_tpu_torch.search import fused_stream as tfs
from tests.test_escalation import CFG, _pairs
from tests.test_torch_fused_stream import _port_cfg

torch.set_num_threads(1)


def test_migrate_row_capacity_equals_jax():
    """The same in-flight row (the JAX stream's state after 6 global
    iterations, carried over leaf by leaf) widened 16 -> 48 by both
    packages: equal leaves, INF tail, sorted frontier."""
    jpairs = _pairs(1)
    jst = jfs._jit_init(CFG)(jstack_pairs(jpairs))
    jst = jfs.fused_run_chunk(jstack_pairs(jpairs), CFG, jst, np.int32(6))
    jrow = jax.tree_util.tree_map(lambda x: x[0], jst)
    cfg2 = dataclasses.replace(CFG, trans_capacity=48)
    want = jfs.migrate_row_capacity(jrow, CFG, cfg2)
    row = tfs.stream_state_from_jax(jrow, "cpu")
    got = tfs.migrate_row_capacity(row, _port_cfg(CFG),
                                   _port_cfg(CFG, trans_capacity=48))
    assert set(got) == set(want) and set(got["inner"]) == set(want["inner"])
    for k, v in tfs._flat_items(got):
        w = dict(tfs._flat_items(want))[k]
        np.testing.assert_array_equal(v.numpy(), np.asarray(w), k)
    lbs = got["inner"]["lbs"].numpy()
    assert lbs.shape[1] == 48 and np.isinf(lbs[:, 16:]).all()
    assert (np.sort(lbs, axis=1) == lbs).all()
    assert got["inner"]["cvals"].shape[1] == 48
    # the same capacity is the same state
    assert tfs.migrate_row_capacity(row, _port_cfg(CFG),
                                    _port_cfg(CFG)) is row


def test_escalated_stream_matches_plain():
    """Every pair alive after 2 chunks of 8 global iterations finishes at
    capacity 48 in the deferred phase: still converged, and within the
    search's epsilon of the plain stream."""
    jpairs = _pairs(3)
    pairs = [pair_from_jax(p, "cpu") for p in jpairs]
    cfg = _port_cfg(CFG)
    plain = tfs.register_fused_stream(pairs, cfg, width=2, chunk_steps=8)
    assert np.asarray(plain.converged).all()
    tfs.reset_counters()
    esc = tfs.register_fused_stream(pairs, cfg, width=2, chunk_steps=8,
                                    escalate_capacity=48,
                                    escalate_after_chunks=2)
    assert np.asarray(esc.converged).all()
    assert tfs.counters["escalated"] == 2      # of the 3 pairs
    # the deeper frontier drops fewer nodes: the escalated trajectories
    # differ from the plain run's after the migration
    assert (np.asarray(esc.evals) != np.asarray(plain.evals)).any()
    for i, p in enumerate(pairs):
        eps = CFG.MSEThresh * float(p.counts[1])
        assert abs(float(esc.error[i]) - float(plain.error[i])) <= eps + 1e-5


@pytest.mark.parametrize("kw,match", [
    (dict(escalate_capacity=48, checkpoint_path="ck.npz"), "checkpoint"),
    (dict(escalate_capacity=16), "must exceed"),
    (dict(escalate_capacity=8), "must exceed"),
])
def test_escalation_rejects(tmp_path, kw, match):
    """Checkpoints do not carry the deferred pairs; an escalation that does
    not widen the frontier would be a silent no-op."""
    pairs = [pair_from_jax(p, "cpu") for p in _pairs(2)]
    if "checkpoint_path" in kw:
        kw = dict(kw, checkpoint_path=str(tmp_path / kw["checkpoint_path"]))
    with pytest.raises(ValueError, match=match):
        tfs.register_fused_stream(pairs, _port_cfg(CFG), width=2, **kw)
