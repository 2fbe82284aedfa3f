"""The fork's three error options as bench configurations.

Each option is the bench's search shape (`bench_shape(GoICPConfig())`)
plus one of the error-function choices that set the fork apart from plain
Go-ICP:

  * l1:   norm=1, every bound and score sums d instead of d^2;
          regularization and ponderation stay at their defaults, so the
          incompatibility count is the only chem term and K2/K4 stay on
          the path;
  * fpfh: cfpfh=1, regularizationFPFH=0.001, the c-FPFH descriptor term
          (descriptors from `seeded_descriptors`);
  * nbr:  regularizationNeighbors=0.001, the neighbour-mismatch term.

Each option runs on 4 similar and 2 trimmed pairs of the bench pools
(`synthetic_pool(64, 7)`, `synthetic_pool_trimmed(32, 23)`) with one
MSEThresh for all of its pairs.  The pairs were chosen by registering
syn00-syn13 and trm00-trm07 under each option with the JAX package on the
CPU and keeping pairs whose searches are short.  `option_rows.jsonl` holds
the JAX package's register_device result of every (option, pair), and
its host engine's result on each option's first pair ("host"), written by
`python tests/test_torch_device_engine.py --write-rows`.

option_config maps a GoICPConfig of either package to the option's
configuration.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from goicp_tpu_torch.bench.measure import TRIM_FRACTION
from goicp_tpu_torch.chem.properties import NUM_PROPS
from goicp_tpu_torch.io.cfpfh import NUM_BINS

OPTION_ROWS = pathlib.Path(__file__).with_name("option_rows.jsonl")
DESCRIPTOR_SEED = 41         # the seeded descriptors' generator
DESCRIPTOR_NOISE = 0.3       # std of their per-point noise

# MSEThresh 0.01 (GoICPConfig's) for every option: timed with the JAX
# package on the CPU, every pair below converges in at most 86 inner
# iterations under it, L1 included (its epsilon is in units of d, not d^2)
OPTIONS = {
    "l1": dict(norm=1, MSEThresh=0.01),
    "fpfh": dict(cfpfh=1, regularizationFPFH=0.001, MSEThresh=0.01),
    "nbr": dict(regularizationNeighbors=0.001, MSEThresh=0.01),
}
# 4 similar and 2 trimmed pairs each, the first the cheapest (the CPU tests
# run it); syn02, which holds most of the similar pool's search, is left out
OPTION_PAIRS = {
    "l1": ("syn13", "syn00", "syn01", "syn05", "trm01", "trm06"),
    "fpfh": ("syn13", "syn00", "syn06", "syn08", "trm03", "trm06"),
    "nbr": ("syn13", "syn01", "syn06", "syn08", "trm02", "trm03"),
}


def option_config(cfg, option: str, trimmed: bool = False):
    """cfg (bench_shape(GoICPConfig()) of either package) with the
    option's fields; trimmed: the trimmed pool's trimFraction and
    frontier, as the bench registers it."""
    cfg = dataclasses.replace(cfg, **OPTIONS[option])
    if trimmed:
        cfg = dataclasses.replace(cfg, trimFraction=TRIM_FRACTION,
                                  trans_capacity=256)
    return cfg


def seeded_descriptors(data_props, model_props, seed: int = DESCRIPTOR_SEED):
    """(source (Nd, 41), target (Nm, 41)) float64 c-FPFH descriptors of a
    pair's points, from their dense property indices: one generator,
    np.random.default_rng(seed), draws a base table of 9 x 41 bins (one
    row per property, uniform in [0, 10)), then per-point Gaussian noise of
    std DESCRIPTOR_NOISE for the source's points and then the target's;
    each point is its property's row plus its noise, rounded to 4 decimals
    (what a descriptor file holds).  Points of one property carry close
    descriptors, points of different properties distant ones, so the
    c-FPFH term is small at the planted alignment and large away from it;
    no correspondence is needed."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(0.0, 10.0, (NUM_PROPS, NUM_BINS))
    out = []
    for props in (data_props, model_props):
        base = table[np.asarray(props, dtype=np.int64)]
        noise = rng.normal(0.0, DESCRIPTOR_NOISE, base.shape)
        out.append(np.round(base + noise, 4))
    return tuple(out)


def option_rows(path=OPTION_ROWS) -> dict:
    """{(option, pair): row} of option_rows.jsonl."""
    with open(path) as fh:
        return {(r["option"], r["pair"]): r for r in map(json.loads, fh)}
