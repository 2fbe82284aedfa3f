"""Argument blocks and output sets of the kernels a run calls many times
with the same tensors: csrc/transition.cu's goicp_harvest and
goicp_advance (search/transition.py) and csrc/inner.cu's goicp_inner_run
(search/inner.py::inner_run).

A block (TransitionArgs) holds one call site's checked pointer slots, the
ints and the tensors they were checked for, and re-checks only the slots
that hold another tensor object at the next call; a run's
TransitionBuffers hands out each kind of call's outputs from two sets
used in turn and keeps a block for each set, and the run's RefineRecord:
the refine block the transitions read, which search/pick.py's kernels
write (csrc/score.cu).
"""

from __future__ import annotations

import ctypes
import math

import torch


def _checked(name: str, item, rows: int, dev, hold=None,
             who: str = "transition") -> int:
    """A slot's pointer (0 for None): item (tensor, per-row shape, dtype)
    must be a tensor of that type on dev with `rows` rows, contiguous.
    hold: a list for inputs, which may be strided (the packed stream's
    unpacked view): a contiguous copy is made and kept there until the
    launch; an output (hold None) is written where it lies.  The
    ValueError names the caller (`who`) and the slot."""
    if item is None:
        return 0
    x, shape, dt = item
    n = rows * math.prod(shape)
    if hold is not None and not x.is_contiguous():
        x = x.contiguous()
        hold.append(x)
    if x.device != dev or x.dtype != dt or x.numel() != n \
            or not x.is_contiguous():
        raise ValueError(
            f"{who}: {name} must be a contiguous {dt} tensor of {n} "
            f"elements on {dev}; got {x.dtype} {tuple(x.shape)} on "
            f"{x.device}{'' if x.is_contiguous() else ', not contiguous'}")
    return x.data_ptr()


def _storages(xs) -> set:
    return {x.untyped_storage().data_ptr() for x in xs if x is not None}


class TransitionArgs:
    """One call site's checked slots, ready to pass to goicp_harvest,
    goicp_advance or goicp_inner_run: the packed pointer array (`ptrs`),
    the ints, the translation root and a buffer for the served rows (and
    out_rows).

    Built from the slot tensors with _checked's rules (and its ValueError,
    naming the slot).  The block holds the tensors it was checked for;
    bind(tensors) re-checks only the slots that now hold another tensor
    object (`rechecked` counts them), so a call with the same tensors
    costs one comparison a slot.  An input that had to be copied (a
    strided view: _checked's hold) makes the block single-use: its copy
    is of this call's values."""

    def __init__(self, specs: tuple, tensors: tuple, n_in: int, dev, ints,
                 root=None, n: int = 0, out_rows: bool = False,
                 who: str = "transition"):
        self.specs = specs      # per slot: (name, per-row shape, dtype, rows)
        self.n_in = n_in        # the first n_in slots are inputs
        self.dev = dev
        self.ptrs = (ctypes.c_ulonglong * len(specs))()
        self.ints = (ctypes.c_int * len(ints))(*ints)
        self.root = None if root is None else (ctypes.c_float * 4)(*root)
        self.rows = (ctypes.c_int * max(n, 1))()
        self.out_rows = (ctypes.c_int * max(n, 1))() if out_rows else None
        self.who = who
        self.copies: dict = {}
        self.rechecked = 0
        self.tensors: tuple = (None,) * len(specs)
        self._check(range(len(specs)), tensors)

    @property
    def reusable(self) -> bool:
        return not self.copies

    def _check(self, slots, tensors: tuple):
        for i in slots:
            name, shape, dt, rows = self.specs[i]
            x = tensors[i]
            hold: list | None = [] if i < self.n_in else None
            self.ptrs[i] = _checked(
                name, None if x is None else (x, shape, dt), rows, self.dev,
                hold, self.who)
            if hold:
                self.copies[i] = hold[0]
            else:
                self.copies.pop(i, None)
        self.tensors = tensors

    def bind(self, tensors: tuple) -> "TransitionArgs":
        """The block for `tensors`: the slots whose tensors are not the
        block's re-checked."""
        changed = [i for i, (a, b) in enumerate(zip(tensors, self.tensors))
                   if a is not b]
        self.rechecked += len(changed)
        self._check(changed, tensors)
        return self


class TransitionBuffers:
    """A run's transition buffers: the outputs of each kind of call (the
    harvest of n rows, the pop, the adoption, and the inner run between
    them: inner.inner_run(bufs=)) in two sets used in turn, as
    search/inner.py's StepBuffers keeps the inner step's, and an argument
    block (TransitionArgs) for each set and for each kind of call into
    outputs of its caller.  A call writes into the set whose turn it is
    unless that set holds one of its inputs (then the other; a new set,
    with a block built for the call, where both do), so what a call
    returned stays valid until the call after next of its kind.  Made
    once per run.  The CPU route (harvest_plain, advance_plain) takes the
    same sets."""

    def __init__(self):
        self.sets: dict = {}        # kind -> [(outputs, storages) or None] * 2
        self.turn: dict = {}
        self.blocks: dict = {}      # (kind, set index or "out") -> block
        self.record = RefineRecord()

    def take(self, kind, alloc, inputs=()) -> tuple:
        """(index, outputs): the next output set of `kind` that holds none
        of `inputs`; (None, new outputs) where both do."""
        pair = self.sets.setdefault(kind, [None, None])
        first = self.turn.get(kind, 0)
        held = _storages(inputs)
        for idx in (first, 1 - first):
            if pair[idx] is None:
                out = alloc()
                pair[idx] = (out, _storages(_leaves(out)))
            out, mem = pair[idx]
            if mem.isdisjoint(held):
                self.turn[kind] = 1 - idx
                return idx, out
        return None, alloc()

    def block(self, site, tensors: tuple, make) -> TransitionArgs:
        """The argument block of `site` bound to `tensors` (made with
        make(tensors) the first time, and kept while it is reusable)."""
        blk = self.blocks.get(site)
        blk = make(tensors) if blk is None else blk.bind(tensors)
        if blk.reusable:
            self.blocks[site] = blk
        else:
            self.blocks.pop(site, None)
        return blk


# the refine block's fields, in the order advance's slots take them
# (search/transition.py): name, per-row shape, dtype
REFINE_FIELDS = (("icp_R", (3, 3), torch.float32),
                 ("icp_t", (3,), torch.float32),
                 ("icp_err", (), torch.float32),
                 ("icp_terms", (3,), torch.float32),
                 ("icp_incomp", (), torch.int32),
                 ("bnb_comp", (), torch.int32),
                 ("do_icp", (), torch.bool))


class RefineRows(dict):
    """The refine block of n rows as transition.advance reads it (a dict
    of REFINE_FIELDS' tensors, (n,) + shape each) and, on the card, the
    fields' pointers in that order (`ptrs`, a c_ulonglong[7]) for
    csrc/score.cu's seeds and pick."""

    def __init__(self, n: int, dev):
        super().__init__((k, torch.empty((n,) + shape, dtype=dt, device=dev))
                         for k, shape, dt in REFINE_FIELDS)
        self.n = n
        self.ptrs = (ctypes.c_ulonglong * len(REFINE_FIELDS))(
            *(v.data_ptr() for v in self.values())) \
            if torch.device(dev).type == "cuda" else None


class RefineRecord:
    """A run's refine record: the refine block of n rows (RefineRows) that
    its transitions read, made once per n and device, and the buffers of
    the ICP seeds (K) that a refinement starts from.  search/pick.py
    writes it: a transition's first refinement sets the rows to the dummy
    of a row that did not refine unless every row refines (in the seeds'
    launch), and each refining row's pick writes its row.  What a
    transition reads is valid until the next one's refinement."""

    def __init__(self):
        self._rows: dict = {}
        self._seeds: dict = {}

    def rows(self, n: int, dev) -> RefineRows:
        key = (n, str(dev))
        if key not in self._rows:
            self._rows[key] = RefineRows(n, dev)
        return self._rows[key]

    def seeds(self, K: int, dev) -> tuple:
        """(R (K, 3, 3), t (K, 3)) float32: where the seeds are written."""
        key = (K, str(dev))
        if key not in self._seeds:
            self._seeds[key] = (
                torch.empty((K, 3, 3), dtype=torch.float32, device=dev),
                torch.empty((K, 3), dtype=torch.float32, device=dev))
        return self._seeds[key]


def _leaves(d: dict) -> list:
    out = []
    for v in d.values():
        if isinstance(v, dict):
            out += _leaves(v)
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def _call_block(bufs, kind, alloc, ins: tuple, outs, make, out=None,
                extra: tuple = ()):
    """(outputs, argument block) of one kernel call with the input slot
    tensors `ins`; outs(o) gives the output slot tensors of outputs o.
    out None: the set of `kind` bufs.take hands out, or new outputs
    without bufs; else out itself.  The block is bufs' for that set (or
    for `kind` into a caller's out) and `extra` (what else the block's
    slots and ints depend on), or built for the call."""
    if out is None:
        idx, out = (None, alloc()) if bufs is None \
            else bufs.take(kind, alloc, ins)
    else:
        idx = "out"
    t = ins + outs(out)
    if bufs is None or idx is None:
        return out, make(t)
    return out, bufs.block(kind + (idx,) + extra, t, make)
