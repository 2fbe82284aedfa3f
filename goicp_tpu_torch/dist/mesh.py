"""Device-mesh parallelism for the BnB search, on torch.distributed.

Port of goicp_tpu/dist/mesh.py.  The JAX package lays a `data` x `search`
Mesh over its devices and lets XLA (NamedSharding, shard_map) insert the
collectives.  Here the model is SPMD: one process (rank) per device, each
running the same program, with one process group per mesh row (`search`)
and per mesh column (`data`) and the collectives written out:

  * `data` axis — pair-level data parallelism: each data rank registers
    its block of the pair axis, and the blocks are all-gathered at the end;
  * `search` axis — intra-pair search parallelism: the L rotation lanes of
    one outer step split over the search ranks, each running the inner
    translation BnB (and its kernels) on its L/n lanes; the per-lane results
    are all-gathered, and the cross-lane reductions run replicated.

Global rank g sits at (g // n_search, g % n_search), the layout of JAX's
`devices.reshape(n_data, n_search)`.  Every input is host-replicated:
every rank prepares the same pairs, as JAX's put_global assumes.  Backends:
NCCL for CUDA devices, gloo for the CPU; gloo also carries CUDA tensors
(the list-form all_gather and all_reduce used here), which lets several
ranks share one card, where NCCL refuses a second rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from goicp_tpu_torch.config import GoICPConfig
from goicp_tpu_torch.pipeline.prepare import PairData
from goicp_tpu_torch.search.inner import InnerResult, inner_bnb

TIMEOUT_S = 600.0     # a collective that waits longer fails its rank
MIN, MAX, SUM = dist.ReduceOp.MIN, dist.ReduceOp.MAX, dist.ReduceOp.SUM


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None,
                     backend: str | None = None,
                     timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the process group of this run; returns this rank's device.

    coordinator_address "host:port" with num_processes and process_id, or
    nothing to read torchrun's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK).  device None: the card `LOCAL_RANK` (else
    process_id modulo the cards); without a card an error, as
    goicp_tpu_torch.default_device().  backend None: NCCL for a CUDA
    device, gloo for the CPU.  timeout_s bounds every collective."""
    if device is None:
        if not torch.cuda.is_available():
            from goicp_tpu_torch import default_device
            default_device()                         # raises
        local = int(os.environ.get("LOCAL_RANK",
                                   (process_id or 0)
                                   % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {}
    if coordinator_address is not None:
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, timeout=datetime.timedelta(
        seconds=timeout_s), **kw)
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an n_data x n_search mesh: its coordinate on
    each axis, the process group along each axis, and its device."""
    n_data: int
    n_search: int
    data_rank: int
    search_rank: int
    data_group: object
    search_group: object
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "search": self.n_search}

    def _axis(self, axis: str):
        if axis == "data":
            return self.data_group, self.n_data
        if axis == "search":
            return self.search_group, self.n_search
        raise ValueError(f"unknown mesh axis {axis!r}")

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """(*s) on every rank of the axis -> (n, *s), in axis order."""
        group, n = self._axis(axis)
        x, undo = _wire(t)
        outs = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(outs, x, group=group)
        return undo(torch.stack(outs))

    def all_reduce(self, t: torch.Tensor, op, axis: str) -> torch.Tensor:
        """The elementwise reduction (MIN, MAX, SUM) of t over the axis."""
        group, _ = self._axis(axis)
        x, undo = _wire(t)
        x = x.clone()
        dist.all_reduce(x, op=op, group=group)
        return undo(x)

    def block(self, n: int, axis: str) -> slice:
        """This rank's contiguous block of an axis of n entries that splits
        evenly over the mesh axis."""
        size = self.shape[axis]
        if n % size:
            raise ValueError(f"{n} entries do not split over the {axis} "
                             f"axis of size {size}")
        me = self.data_rank if axis == "data" else self.search_rank
        return slice(me * (n // size), (me + 1) * (n // size))


def _wire(t: torch.Tensor):
    """The tensor a collective carries (bool as uint8) and the map back."""
    dtype = t.dtype
    x = t.to(torch.uint8) if dtype == torch.bool else t
    return x.contiguous(), lambda y: y.to(dtype)


def make_mesh(n_data: int = 1, n_search: int | None = None,
              device=None, timeout_s: float = TIMEOUT_S) -> Mesh | None:
    """Lay the first n_data * n_search ranks of the process group out as a
    data x search mesh (n_search None: all ranks).  Every rank must call
    it, in the same order as the others, since every rank takes part in
    creating every group; ranks outside the mesh get None.  device None:
    the current card (init_distributed sets it), else an error."""
    world = dist.get_world_size()
    n_search = n_search or world // n_data
    if n_data * n_search > world or n_data < 1 or n_search < 1:
        raise ValueError(f"a {n_data} x {n_search} mesh needs "
                         f"{n_data * n_search} ranks; the group has {world}")
    if device is None:
        if not torch.cuda.is_available():
            from goicp_tpu_torch import default_device
            default_device()                         # raises
        device = torch.device("cuda", torch.cuda.current_device())
    timeout = datetime.timedelta(seconds=timeout_s)
    rank = dist.get_rank()
    rows = [dist.new_group([d * n_search + s for s in range(n_search)],
                           timeout=timeout) for d in range(n_data)]
    cols = [dist.new_group([d * n_search + s for d in range(n_data)],
                           timeout=timeout) for s in range(n_search)]
    if rank >= n_data * n_search:
        return None
    d, s = divmod(rank, n_search)
    return Mesh(n_data=n_data, n_search=n_search, data_rank=d,
                search_rank=s, data_group=cols[s], search_group=rows[d],
                device=torch.device(device))


def stack_pairs(pairs: list[PairData]) -> PairData:
    """Stack equal-shaped PairData along a new leading pair axis.

    All pairs must share Nd/Nm and grid padding (use prepare_pair's
    pad_cells/pad_points).  Host-side metadata (n_cells, GridGeometry)
    legitimately differs per pair — per-pair geometry travels in the
    `consts` tensor — so the result keeps the first pair's."""
    assert len({p.n_data for p in pairs}) == 1
    assert len({p.n_model for p in pairs}) == 1
    assert len({p.inlier_num for p in pairs}) == 1
    flat = [_leaves(p) for p in pairs]
    stacked = iter([torch.stack(ts) for ts in zip(*flat)])
    return pairs[0].map_tensors(lambda _: next(stacked))


def _leaves(pair: PairData) -> list:
    out = []
    pair.map_tensors(lambda t: out.append(t) or t)
    return out


def put_global(x, mesh: Mesh):
    """This rank's rows of the pair axis (the leading axis, split over
    `data`) of a host-replicated stacked PairData or tensor."""
    def take(t):
        return t[mesh.block(t.shape[0], "data")]
    return x.map_tensors(take) if isinstance(x, PairData) else take(x)


def map_pair_blocks(mesh: Mesh, pairs: list, fn):
    """Pair-level data parallelism: the pair axis split into n_data equal
    blocks (the last ones padded with pair 0), fn(block, n_live) -> a
    NamedTuple of numpy arrays with one row per block entry run on this
    rank's block (entries from n_live on are padding, which fn need not
    search), and the blocks all-gathered over `data`: every rank returns
    the rows of all B pairs, in pair order.  A failure on any data rank
    raises on all of them instead of leaving the others in a collective."""
    B = len(pairs)
    per = -(-B // mesh.n_data)
    block = pairs[mesh.data_rank * per:(mesh.data_rank + 1) * per]
    n_live = len(block)
    err = out = None
    try:
        out = fn(block + [pairs[0]] * (per - n_live), n_live)
    except Exception as exc:    # every data rank must reach the collective
        err = exc
    failed = mesh.all_reduce(torch.tensor(int(err is not None),
                                          device=mesh.device), MAX, "data")
    if err is not None:
        raise err
    if int(failed):
        raise RuntimeError("another data rank of the mesh failed")
    return type(out)(*(
        mesh.all_gather(torch.as_tensor(v, device=mesh.device), "data")
        .flatten(0, 1)[:B].cpu().numpy() for v in out))


def rank_path(path: str) -> str:
    """A file name of this rank's own: `path` with `.rank<r>of<n>` before
    its extension (each rank's checkpoint of its block)."""
    root, ext = os.path.splitext(path)
    return f"{root}.rank{dist.get_rank()}of{dist.get_world_size()}{ext}"


def gather_lanes(res: InnerResult, mesh: Mesh) -> InnerResult:
    """An InnerResult over this rank's lane block (lane axis last of the
    per-lane fields, any leading axes) -> the whole lane axis on every
    search rank: the per-lane fields all-gathered, evals, geom_surv and
    chem_corners summed, iters the max (the inner loop of the whole lane
    set runs until its slowest lane is done)."""
    lanes = torch.cat([res.best_err[..., None], res.best_node,
                       res.lb_safe[..., None], res.ub_terms], dim=-1)
    g = mesh.all_gather(lanes, "search")               # (n, ..., Ll, 9)
    g = g.movedim(0, -3).flatten(-3, -2)               # (..., n * Ll, 9)
    dev = lanes.device
    sums = mesh.all_reduce(torch.stack([
        torch.as_tensor(v, device=dev).to(torch.int64)
        for v in (res.evals, res.geom_surv, res.chem_corners)]), SUM,
        "search")
    iters = mesh.all_reduce(torch.as_tensor(res.iters, device=dev)
                            .to(torch.int64), MAX, "search")
    return InnerResult(best_err=g[..., 0], best_node=g[..., 1:5],
                       lb_safe=g[..., 5], ub_terms=g[..., 6:9], iters=iters,
                       evals=sums[0], geom_surv=sums[1],
                       chem_corners=sums[2])


def sharded_inner_step(mesh: Mesh, cfg: GoICPConfig,
                       with_rot_uncertainty: bool, fused: bool = False):
    """A pair-batched, lane-sharded inner-BnB step.

    Returns fn(stacked_pair, pts_rot (Pb,L,Nd,3), widths (Pb,L),
    active (Pb,L), opt_err (Pb,)) -> InnerResult with leading (Pb, L)
    axes ((Pb,) for iters, evals, geom_surv, chem_corners), the whole of it
    on every rank.  The inputs are host-replicated; each rank runs its rows
    (Pb split over `data`) and lanes (L split over `search`).  fused=True
    runs the single-pass ub+lb search (see search/inner.py)."""
    def fn(stacked_pair, pts_rot, widths, active, opt_err):
        Pb, L = widths.shape
        lanes = mesh.block(L, "search")
        rows = []
        for b in range(Pb)[mesh.block(Pb, "data")]:
            pair = stacked_pair.map_tensors(lambda t: t[b])
            rows.append(inner_bnb(pair, cfg, pts_rot[b, lanes],
                                  widths[b, lanes], active[b, lanes],
                                  opt_err[b],
                                  with_rot_uncertainty=with_rot_uncertainty,
                                  fused=fused))
        mine = gather_lanes(InnerResult(*(
            torch.stack([torch.as_tensor(getattr(r, f), device=pts_rot.device)
                         for r in rows])
            for f in InnerResult._fields)), mesh)
        return InnerResult(*(mesh.all_gather(v, "data").flatten(0, 1)
                             for v in mine))
    return fn


def reduce_best(errs: torch.Tensor, mesh: Mesh, axis: str = "search"
                ) -> torch.Tensor:
    """Global min of the incumbent candidates over a mesh axis (the
    collective analogue of the scalar optError update at
    jly_goicp.cpp:771-781)."""
    return mesh.all_reduce(torch.amin(errs), MIN, axis)
