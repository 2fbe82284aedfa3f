"""Search configuration.

Port of goicp_tpu/config.py: the same names, defaults and derived
properties, so a configuration means the same search in both packages.
The reference keys mirror the reference's `config.txt`; the rest shape the
batched search (batch sizes, frontier capacities, iteration caps, the
cross-pair streams' slot budgets) and only affect speed or pruning
efficiency, never epsilon-optimality.  `from_file` reads a reference-style
`config.txt` (`key=value`, `#` comments); keys the dataclass lacks are
ignored, as the JAX package ignores them.
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class GoICPConfig:
    # ---- reference keys ----
    MSEThresh: float = 0.01
    norm: int = 2                    # 1 = L1, 2 = L2
    regularization: float = 0.0005   # chem incompatibility weight
    regularizationNeighbors: float = 0.0
    ponderation: int = 1             # 1 = weights 1 + 2*minN/neighbors
    cfpfh: int = 0                   # 0 off; 1, 2, 3 = bin sets (io/cfpfh)
    regularizationFPFH: float = 0.0
    rotMinX: float = -3.1416
    rotMinY: float = -3.1416
    rotMinZ: float = -3.1416
    rotWidth: float = 6.2832
    transMinX: float = -0.5
    transMinY: float = -0.5
    transMinZ: float = -0.5
    transWidth: float = 1.0
    trimFraction: float = 0.0
    distTransSize: int = 20
    distTransExpandFactor: float = 2.0

    # ---- batched search shape ----
    rot_batch: int = 8           # rotation cubes popped per outer step
    trans_capacity: int = 128    # translation frontier width per lane
    trans_pop: int = 8           # translation nodes expanded per iteration
    inner_max_iters: int = 200   # inner BnB iteration cap per invocation
    rot_frontier_capacity: int = 500_000  # host engine's outer frontier cap
    device_rot_capacity: int = 2048  # device engine's outer frontier cap
    icp_max_iter: int = 200
    max_outer_steps: int = 100_000
    icp_seeds: int = 1           # ICP the K lowest-ub lanes per outer step
    margin_frac: float = 1.0     # search to margin_frac * MSEThresh * N
    icp_on_improve: int = 1      # ICP only on improving outer steps
    fused_inner: int = 1         # one fused ub+lb inner search per step
    packed_slots: int = 8        # packed stream (search/packed_stream.py):
                                 # lanes served per global iteration
    packed_trans_every: int = 8  # packed stream: transitions fire every N
                                 # global iterations
    lane_compaction: int = 1     # staged inner-lane compaction L->L/2->L/4
    init_seeds: int = 1          # initial-incumbent ICP multi-start count
    chem_reuse: int = 0          # frontier nodes carry their corners' chem
    trans_slots: int = 0         # fused/packed streams: >0 serves at most K
                                 # transitioning pairs per event (0 = all)
    sorted_merge: int = 0        # 1 = frontier insert by a rank merge of the
                                 # sorted children against the sorted
                                 # remainder (the same order as one sort)
    chem_survivors: int = 0      # >0: two-phase bounds, chem corners only
                                 # for the N lowest-lb geometric survivors
                                 # per lane (8 * trans_pop = every child)

    # ---- derived ----
    @property
    def doTrim(self) -> bool:
        return self.trimFraction >= 0.001

    @property
    def err_diff(self) -> float:
        """ICP convergence threshold."""
        return self.MSEThresh / 10000.0

    @property
    def mse_margin(self) -> float:
        """The per-point epsilon the engines search to."""
        return self.MSEThresh * self.margin_frac

    def validate(self) -> "GoICPConfig":
        if self.norm not in (1, 2):
            raise ValueError("norm must be 1 (L1) or 2 (L2)")
        if self.cfpfh not in (0, 1, 2, 3):
            raise ValueError(f"cfpfh must be 0, 1, 2 or 3, not {self.cfpfh}")
        if self.distTransSize < 2:
            raise ValueError("distTransSize must be >= 2")
        if not 0.0 <= self.trimFraction < 1.0:
            raise ValueError("trimFraction must lie in [0, 1)")
        return self

    @classmethod
    def from_file(cls, path: str) -> "GoICPConfig":
        return cls.from_dict(parse_config_file(path))

    @classmethod
    def from_dict(cls, values: dict) -> "GoICPConfig":
        """Field values from strings; int fields accept '8' and '8.0'."""
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in values:
                raw = values[f.name]
                kwargs[f.name] = int(float(raw)) if f.type in ("int", int) \
                    else float(raw)
        return cls(**kwargs).validate()


def parse_config_file(path: str) -> dict:
    """A reference-style config file -> {key: value string}: `key=value`
    (or `key value`, `key;value`), `#` starts a comment."""
    values = {}
    with open(path, "r") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r"([A-Za-z0-9_]+)\s*[=; ]\s*(\S+)", line)
            if m:
                values[m.group(1)] = m.group(2)
    return values
