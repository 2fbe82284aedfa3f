"""Argument blocks and output sets of the kernels a run calls many times
with the same tensors: csrc/transition.cu's goicp_harvest and
goicp_advance (search/transition.py) and csrc/inner.cu's goicp_inner_run
(search/inner.py::inner_run).

A block (TransitionArgs) holds one call site's checked pointer slots, the
ints and the tensors they were checked for, and re-checks only the slots
that hold another tensor object at the next call; a run's
TransitionBuffers hands out each kind of call's outputs from two sets
used in turn and keeps a block for each set, and the run's RefineRecord:
the refine block the transitions read, which search/pick.py's refine
route writes (csrc/icp.cu), with that launch's own argument block
(RefineArgs).  RunHead names the harvest an inner run makes at its end
(inner.inner_run(head=)); the buffers keep the fused stream's fin0 and
the pinned host words an event is read into.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

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
        self._kept: dict = {}

    def fin0(self, W: int, dev) -> torch.Tensor:
        """The fused stream's (W,) bool: each row finished at the chunk's
        first event (its event head writes it)."""
        key = ("fin0", W, str(dev))
        if key not in self._kept:
            self._kept[key] = torch.zeros((W,), dtype=torch.bool, device=dev)
        return self._kept[key]

    def host_words(self, words: torch.Tensor) -> torch.Tensor:
        """A pinned host tensor of words' shape and type, kept: what an
        event's words are copied into (one copy, the event's host read)."""
        key = ("host", tuple(words.shape), words.dtype)
        if key not in self._kept:
            self._kept[key] = torch.empty(words.shape, dtype=words.dtype,
                                          pin_memory=True)
        return self._kept[key]

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


REFINE_ROWS = 16     # rows a refine launch carries (csrc/icp.cu)
REFINE_SLOTS = 21    # pointers a refine row takes (search/pick.py)


class RefineArgs:
    """The refine route's argument block (csrc/icp.cu's goicp_icp_refine):
    REFINE_SLOTS pointers a row (`slots`), the rows' record rows (`j`),
    the ints and the floats.  A row's slots are re-checked (by the
    caller's `check`, which raises ValueError) only where the row now
    holds another tensor object than at the call before (`rechecked`
    counts them); the ints are rebuilt only where their key changed."""

    def __init__(self):
        self.cap = 0
        self.slots = None
        self.j = None
        self.held: list = []       # per row: the tensors its slots hold
        self.key = None
        self.ints = None
        self.floats = None
        self.copies: list = []     # this call's contiguous copies
        self.rechecked = 0

    def bind(self, rows: list, check) -> "RefineArgs":
        """Bind rows [(j, tensors)]: check(k, x) -> x (a contiguous tensor
        to point at) for each slot k whose tensor changed."""
        n = len(rows)
        if n > self.cap:
            cap = max(n, 2 * self.cap)
            slots = (ctypes.c_ulonglong * (cap * REFINE_SLOTS))()
            j = (ctypes.c_int * cap)()
            if self.cap:
                ctypes.memmove(slots, self.slots,
                               ctypes.sizeof(self.slots))
            self.slots, self.j, self.cap = slots, j, cap
            self.held += [(None,) * REFINE_SLOTS] * (cap - len(self.held))
        self.copies = []
        for r, (j, ts) in enumerate(rows):
            self.j[r] = j
            held = self.held[r]
            if all(a is b for a, b in zip(ts, held)):
                continue
            kept = list(held)
            for k, (a, b) in enumerate(zip(ts, held)):
                if a is not b:
                    x = check(k, a)
                    self.slots[r * REFINE_SLOTS + k] = x.data_ptr()
                    kept[k] = a
                    if x is not a:      # a copy: this call's, checked again
                        kept[k] = None
                        self.copies.append(x)
                    self.rechecked += 1
            self.held[r] = tuple(kept)
        return self

    def set_ints(self, key, make) -> None:
        """The ints and floats for `key`, made by make() -> (ints, floats)
        where the key changed."""
        if key != self.key:
            ints, floats = make()
            self.ints = (ctypes.c_int * len(ints))(*ints)
            self.floats = (ctypes.c_float * len(floats))(*floats)
            self.key = key


class RefineRecord:
    """A run's refine record: the refine block of n rows (RefineRows) that
    its transitions read, made once per n and device; on the card what the
    refine route's launch needs besides (its argument block, RefineArgs;
    each row's rescoring rows and ticket, the tickets zero between
    launches; the ICP's device workspace where a cloud does not fit a
    block's shared memory), and on the CPU the buffers of the ICP seeds
    (K) that a refinement starts from.  search/pick.py writes it: the rows
    that refine get their picks, the others the dummy of a row that did
    not refine.  What a transition reads is valid until the next one's
    refinement."""

    def __init__(self):
        self._rows: dict = {}
        self._seeds: dict = {}
        self._launch: dict = {}
        self.args = RefineArgs()

    def rows(self, n: int, dev) -> RefineRows:
        key = (n, str(dev))
        if key not in self._rows:
            self._rows[key] = RefineRows(n, dev)
        return self._rows[key]

    def launch_buffers(self, K: int, dev) -> tuple:
        """(rows_ws, tickets) of the refine launch at K seeds: REFINE_ROWS
        rows of 7 (K + 1) + 12 K float32 and REFINE_ROWS int32 tickets,
        zeroed once (the kernel leaves them zero)."""
        key = (K, str(dev))
        if key not in self._launch:
            self._launch[key] = (
                torch.empty((REFINE_ROWS * (7 * (K + 1) + 12 * K),),
                            dtype=torch.float32, device=dev),
                torch.zeros((REFINE_ROWS,), dtype=torch.int32, device=dev))
        return self._launch[key]

    def workspace(self, words: int, dev) -> torch.Tensor:
        """A device workspace of at least `words` float32 (the ICP's
        where its cloud does not fit shared memory), kept and grown."""
        key = ("ws", str(dev))
        ws = self._launch.get(key)
        if ws is None or ws.numel() < words:
            ws = torch.empty((words,), dtype=torch.float32, device=dev)
            self._launch[key] = ws
        return ws

    def seeds(self, K: int, dev) -> tuple:
        """(R (K, 3, 3), t (K, 3)) float32: where the seeds are written."""
        key = (K, str(dev))
        if key not in self._seeds:
            self._seeds[key] = (
                torch.empty((K, 3, 3), dtype=torch.float32, device=dev),
                torch.empty((K, 3), dtype=torch.float32, device=dev))
        return self._seeds[key]


class RunHead(NamedTuple):
    """The harvest an inner run makes at its end, by the last cluster to
    finish (search/inner.py::inner_run(head=); csrc/inner.cu's run_finish,
    the body csrc/harvest_body.cuh): the state's rows that the run's lanes
    belong to (W of them, one a group of lanes), what the harvest reads of
    them beside the lanes, and what it serves.

    Modes search and groups: the rows `rows`, an int32 tensor on the
    lanes' device of indices in [0, W) (register_device's row 0, the batch
    engine's stepping rows), harvested into output rows 0 .. len(rows) - 1
    (search/transition.py::harvest's outputs).  Mode stream
    (`it` given): the fused stream's event head on the W rows (served: the
    first K complete and not converged rows), the run's masks (live, watch,
    once) taken from the state (conv, it, the lanes' done and inner it,
    fin0, eager) instead of the caller's."""
    active: torch.Tensor                 # (W, L) bool
    R_lanes: torch.Tensor                # (W, L, 3, 3) float32
    opt_err: torch.Tensor                # (W,) float32, the incumbent
    conv: torch.Tensor | None            # (W,) bool, the flags' second
    rows: torch.Tensor | None = None     # (n,) int32: search, groups
    it: torch.Tensor | None = None       # (W,) int32: mode stream
    fin0: torch.Tensor | None = None     # (W,) bool: mode stream
    K: int = 0                           # mode stream: rows served at most
    max_outer: int = 0                   # mode stream: max_outer_steps
    eager: bool = False                  # mode stream

    @property
    def event(self) -> bool:
        return self.it is not None


HARVEST_KEYS = ("lb_safe", "ubs", "cand_ub", "incumbent", "cand_R", "cand_t",
                "cand_terms", "flags")


def event_words(W: int, K: int) -> int:
    """The fused stream's event's int32 words: finished, converged and
    complete of each of W rows, the rows served, K served rows, K improved
    flags, the global iterations (csrc/harvest_body.cuh's layout)."""
    return 3 * W + 2 * K + 2


def harvest_rows_of(out: dict, n: int) -> dict:
    """The first n rows of a harvest's outputs (out["h"], a capacity of
    rows) as views, with `improved` = flags[:, 0]; kept in out["views"]
    per n, so that a call given them binds the same tensor objects."""
    views = out.setdefault("views", {})
    if n not in views:
        h = {k: out["h"][k][:n] for k in HARVEST_KEYS}
        h["improved"] = h["flags"][:, 0]
        views[n] = h
    return views[n]


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
