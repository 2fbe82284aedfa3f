"""The port's numpy host helpers and configuration equal the JAX package's
(which the port does not import): the same defaults for every field the
port has, same arrays from the same seeded inputs."""

import dataclasses

import numpy as np
import pytest

from goicp_tpu import config as jconfig
from goicp_tpu.chem import neighbors as jnbrs
from goicp_tpu.chem import properties as jprops
from goicp_tpu.geom import normalize as jnorm
from goicp_tpu.io import cfpfh as jcfpfh
from goicp_tpu.io import xyz as jxyz
from goicp_tpu_torch import config as tconfig
from goicp_tpu_torch.chem import neighbors as tnbrs
from goicp_tpu_torch.chem import properties as tprops
from goicp_tpu_torch.geom import normalize as tnorm
from goicp_tpu_torch.io import cfpfh as tcfpfh
from goicp_tpu_torch.io import xyz as txyz


@pytest.mark.parametrize("kw", [{}, dict(MSEThresh=0.02, margin_frac=0.9,
                                         trimFraction=0.1)])
def test_config_matches_jax(kw):
    j, t = jconfig.GoICPConfig(**kw), tconfig.GoICPConfig(**kw)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    # every field, in the JAX order, with the JAX defaults
    assert td == jd and list(td) == list(jd)
    for prop in ("doTrim", "err_diff", "mse_margin"):
        assert getattr(t, prop) == getattr(j, prop)


def test_normalize_and_quantize_match_jax():
    rng = np.random.default_rng(3)
    src = rng.normal(size=(40, 3)) * 3.0 + 1.5
    tgt = rng.normal(size=(56, 3)) * 2.0 - 0.5
    jn, tn = jnorm.normalize_pair(src, tgt), tnorm.normalize_pair(src, tgt)
    assert jn.keys() == tn.keys()
    for k in jn:
        np.testing.assert_array_equal(tn[k], jn[k])
    for k in ("source", "target"):
        np.testing.assert_array_equal(txyz.quantize_like_file(jn[k]),
                                      jxyz.quantize_like_file(jn[k]))


def test_properties_and_bins_match_jax():
    rng = np.random.default_rng(4)
    codes = np.array(list(jprops.PROP_CODES.values()) + [12345, 7])
    codes = codes[rng.permutation(len(codes))]
    np.testing.assert_array_equal(tprops.codes_to_indices(codes),
                                  jprops.codes_to_indices(codes))
    np.testing.assert_array_equal(tprops.compatibility_matrix(),
                                  jprops.compatibility_matrix())
    desc = rng.uniform(size=(8, 41))
    for mode in (0, 1, 2, 3):
        np.testing.assert_array_equal(tcfpfh.select_bins(desc, mode),
                                      jcfpfh.select_bins(desc, mode))
    with pytest.raises(ValueError):
        tcfpfh.select_bins(desc, 4)


@pytest.mark.parametrize("n", [24, 64])
def test_neighbors_match_jax(n):
    pts = np.random.default_rng(n).uniform(-0.7, 0.7, size=(n, 3))
    for r in (0.05, 0.2):
        np.testing.assert_array_equal(tnbrs.neighbor_counts(pts, r),
                                      jnbrs.neighbor_counts(pts, r))
    np.testing.assert_array_equal(tnbrs.neighbor_weights(pts),
                                  jnbrs.neighbor_weights(pts))
