#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (goicp_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py                  # everything; the result lines
    python3 chip_smoke.py --kernels-only   # phases 1-2; no result
    python3 chip_smoke.py --options        # phases 1, 2 and 11; no result

Phases, each of which fails the script (nonzero exit, no result line):

 1. setup: the card's name and power limit (nvidia-smi), TF32 off, and the
    CUDA kernels of goicp_tpu_torch/csrc built with nvcc (build time on its
    own line, then each kernel's registers, shared memory and spills as
    ptxas reports them), and the time of an empty kernel launched and
    timed the same two ways as the kernels (launch_floor_ms,
    graph_launch_floor_ms).
 2. kernels vs plain: each kernel's wrapper on card tensors at main-path
    shapes (a prepared bench pair, lanes/centers/widths from a numpy seed),
    held against its plain torch version on the same inputs, bit for bit:
    K1 untrimmed (fused and plain modes), K1 with the dynamic K read from
    counts[1] and with a static K, K2 at Q=152 and Q=8, and K1's trimmed
    modes once more on rows of 320 points, which go through the
    shared-memory scratch.  The per-lane-table kernels K3 and K4 at the
    streams' shapes: two prepared pairs of one bucket, 16 lanes
    interleaved between them, equal to their plain versions and lane for
    lane to K1 / K2 run with that lane's pair.  (Kernel and plain version
    take the same float32 per-point distances and sum them in one order,
    utils/fp32.py's: each of a warp's 32 lanes adds its points t, t+32,
    ... and an xor butterfly combines the lanes; trimmed, the values below
    the K-th smallest, then its ties.)  The ordered-sum kernel
    (csrc/ordered_sum.cu) at the rescoring's and the ICP's shapes on
    syn07, equal to its plain version bit for bit and timed the same way,
    alternated with torch.sum (medians of 10; the other shapes in turns);
    rotate (csrc/ordered_sum.cu) at an outer
    transition's shape (8 R x syn07's data) and a rescoring's (4 R, + t),
    norm3 at the rotation centres' (8, 3) and the preparation's (syn07's
    data), sincos32 at (8,), rodrigues of 8 seeded centres and
    rot_uncertainty of 8 widths x syn07's point norms
    (csrc/fp32_products.cu), each equal to its plain version bit for bit,
    in turns with torch.matmul and torch.baddbmm, alternated (medians of
    10) with torch.linalg.vector_norm and, for sincos32, which has no one
    torch call, with torch.sin; rodrigues and rot_uncertainty one kernel
    launch and no memset a call, and bit for bit again on wide inputs
    (zero, axis-aligned and |v| = pi rotation vectors; the BnB's widths
    and clamped ones); so the fixed-order products (csrc/fp32_products.cu:
    sq_dist3, det3, cross3, dot_fma), in turns with torch.linalg.det and
    torch.matmul, cross3 alternated with torch.linalg.cross and bit for
    bit in six layouts.  The ICP kernel
    (csrc/icp.cu): icp_run, one launch an ICP event, held to
    icp_run_plain on the same card tensors bit for bit in R, t, nn_idx,
    err and iters, on syn07 (4 seeds untrimmed; its
    padded bucket with row 1 disabled; one row as the fused stream
    refines it; the 8 initial seeds), trm00 (count + dynamic trim; a
    static trim), the demo's 1000 / 500 points, 4,200 / 4,200 points (the
    workspace in device memory) and 165 / 306 and 306 / 306 points (the
    bench's extremes), each timed an iteration, one launch and no memset
    an event, and ptxas's stack frame and spills of the ICP kernel 0;
    kabsch3 held to kabsch_from_H on zero, rank 1, rank 2, reflected and
    seeded H.  The rescoring kernel (csrc/score.cu, bounds/error.py's
    score_kernel) in its three routes, bit for bit with the torch bodies
    (score_transform_plain and icp_chem_terms' count,
    bnb_incompatibility_count_plain, initial_error_plain) on the ten ICP
    events' results, each on the pair it reads, on syn07's bucket shifted
    far outside its grid and on phase 11's L1, c-FPFH and neighbour
    pairs; timed on syn07's bucket, one launch and no memset a call,
    ptxas's stack frame and spills 0; the card's torch.sum over 3 terms
    against the orders it could take, and dt_distance far outside a grid
    on the card and the CPU bit for bit.  The pick (search/pick.py:
    csrc/score.cu's goicp_score_pick, the best seed of an ICP event with
    the candidate's count written into a refine record, and its initial
    route; goicp_icp_seeds, the K lowest-ub lanes) bit for bit with its
    torch bodies, and the refine route (csrc/icp.cu's goicp_icp_refine:
    every refining row of a transition in one launch, the seeds, the ICP
    event, the rescoring, the pick and the count) bit for bit with the
    plain composition and with the three launches a row it replaced, on
    syn07's bucket at K = 1, 4, 8, 12 (tied, inf and NaN ubs), with the
    ICP disabled and with its workspace in device memory, on a similar
    and a trimmed 2-row window and on phase 11's c-FPFH and neighbour
    pairs; timed with the three launches beside it and its split
    rescoring's ptxas stack and spills 0.  The initial route
    (csrc/icp.cu's goicp_icp_init: an initial incumbent in one launch, the
    ICP events from the initial seeds, their rescoring, the initial error
    and the pick into the state's tensors) bit for bit with the plain
    composition (icp_run_plain, score_initial_plain) and with the two
    launches it replaced (icp_run, score_initial), at K = 1, 4 and 8 on
    syn07's bucket, trm00's dynamic trim and its static trim, on phase
    11's three option pairs and on syn07's bucket with the workspace in
    device memory (C = 1); timed with the two launches beside it.  Every
    prepared pair used here has its Grid.nearest_cell, the table the
    kernels trust, held equal to nearest_occupied over all S^3 voxels.
    One more pair is prepared on a 64^3 grid, whose 1 MB table does not
    fit a block's shared memory: K1 and K2 with the tables read from
    device memory, bit for bit.  K1 once more at the host-streaming
    engine's shape
    (GoICPConfig's rot_batch 8: 64 lanes of 64 nodes) on syn07, fused,
    plain+unc and plain, timed like the others.  Times from CUDA events:
    a kernel's `ms` is the median of
    25 single launches (which on a busy host measures the enqueue, as the
    empty kernel's two times show), its `graph_ms` the per-launch time of
    50 launches replayed from one CUDA graph (the card's time); a plain
    version's is the median of 25 calls.  Both stand beside the kernel's
    bound and the empty kernel's two times.  The bound counts what the
    FUNCTION needs, whatever implements it: a fixed number of operations
    per (lane, node or corner, real point) over 67 TFLOP/s (fp32 outside
    the tensor cores; sincos32's float64 operations over 34 TFLOP/s),
    against its input + output bytes over 3.35 TB/s, each tensor once.
    K1 on syn07 and trm00 (there also fused with a static K) and K3 run
    at norm 2 and again at norm 1 (the fork's L1 option) on the same
    inputs, at the same tolerances, K3 lane for lane equal to K1 at each
    norm (norm 1's times: the JSON line's "norm1" entries).  The inner
    step kernel (csrc/inner.cu, goicp_inner_step: a whole inner-BnB
    iteration, K1-K4's bodies inside it) held to inner_step_plain, the
    torch body, every output field, counter and the active-lane count bit
    for bit over a few steps in each mode of STEP_MODES (fused, plain with
    and without rotation uncertainty, corner reuse or 27 corners, no chem
    term, sorted_merge, norm 1, dynamic and static K, a pop of 80 with a
    capacity of 5000, two pairs' lanes interleaved as two window rows, one
    of them not live; done lanes in every mode) and on built NaN/INF lbs through both merge orders; timed
    at the streams' shape (16 lanes of syn00 + syn01) and at
    register_device's (syn07, 8 lanes).  The inner run (csrc/inner.cu,
    goicp_inner_run: the iterations of a search in one launch, a lane a
    thread-block cluster holding its state in shared memory, no grid
    barrier in modes search and groups) held to inner_run_plain, the
    torch loops it replaces, every lane field, counter and the iteration
    count bit for bit, over the same cases in its three stop modes
    (search: inner_bnb's whole search; groups: the batch engine's; stream:
    the fused stream's, both groups live, one live, and `once`), and
    syn07 at 256 lanes, more than the card holds clusters at once (search
    and groups: a cluster takes one lane after another; stream: the lanes
    stride, their state in device memory), each case printing the lanes
    that ran resident and strided; timed in mode search on syn07 (the
    kernels line) and in mode stream on syn00 + syn01 as the engines call
    it (the run's buffers: one kernel launch and no memset a call,
    checked), beside a call that builds its block and outputs and the
    same iterations as inner_step launches from a CUDA graph.  The transition kernels
    (csrc/transition.cu: goicp_harvest and goicp_advance) held to
    harvest_plain and advance_plain, the engines' torch code, every
    output bit for bit: the streams' mode ("both", one launch of a
    thread-block cluster a row) on four windows 40 global iterations in
    (similar with and without corner reuse, trimmed, and rot_batch 4, so
    that a cluster block serves 4 lanes) in seven cases (as run, improved
    by the BnB candidate or by the ICP, a converging row, a NaN lane, INF
    lbs, a full frontier), every merged frontier first checked sorted and
    NaN-free (the merge path's precondition), the outputs new, written in
    place and taken from a run's two output sets in turn (the kept
    argument blocks of search/transition.py); a kept block whose tensor
    was replaced re-checked and repointed (the harvest and the advance on
    the new values); register_device's pop (with a given min_lb too, and
    at rot_batch 4), harvest and adoption (no refine, refined, frozen) on
    syn07; the batch engine's pop into B-row outputs and at out_rows,
    and adoption in place; timed at the streams' shape (syn02 + syn03)
    and at register_device's, each call with the run's buffers (the main
    path's) and with a block built a call.  max |kernel - plain| is 0 in
    every case.
 3. registrations through the port's entry points: prepare_pair(bucket=
    True) -> make_count_dynamic -> register_device, under GoICPConfig() +
    bench_shape, on six pairs of the similar pool and four of the trimmed
    pool.  Each pair's nearest-cell table is checked as in phase 2, and
    each result is held against the fp32 reference rows (the JAX package's
    register_device on XLA:CPU, goicp_tpu_torch/bench/reference_rows.jsonl)
    and printed beside its sweep383*.jsonl row.  Then syn07 again with
    sorted_merge=1 and with chem_survivors = 8 * trans_pop (every child),
    each equal to phase 3's syn07 in error, R, t, opt_comp, evals, outer,
    inner and geom_surv, and with chem_survivors=8 (capped at twice the
    outer steps; converged or not, an achievable error and a valid gap).
 4. proof: the launch counters of the inner run kernel, the
    transition kernels (harvest, advance: the pop with its root corners
    through K2's body, the adoption), the rescoring kernel, rodrigues
    (the ICP seeds), norm3 and the ordered sum (the preparation) and the
    ICP kernels (icp_init, every initial incumbent's; icp_refine, every
    refinement's), zeroed just before phase 3, are > 0 after it, those
    of the seeds', the pick's and score_initial's own kernels and of
    icp_run (the event alone: the host engine's) 0 (so in phases 5, 6
    and 13), every
    ordered sum launched was the preparation's c-FPFH table (so in phases
    5-9, 12 and 13: the rescoring is one launch of csrc/score.cu; phase
    3's additions and phase 11 print theirs), the inner step kernel's is
    0,
    and neither the torch inner body nor the torch transition ran on the
    card (so in phases 5 and 7-13: every inner search, or a stream's
    iterations up to a transition, was one launch of csrc/inner.cu's
    run; phase 6's packed stream launches the inner step, one an
    iteration; every outer transition went through csrc/transition.cu);
    sq_dist3, det3 and cross3, whose only caller was the plain ICP loop,
    dot_fma, whose other caller was norm3, and sincos32, whose callers
    rodrigues and rot_uncertainty are one launch each, are 0 (so in
    phases 5, 6, 7 and 13; phase 11's row checks launch sq_dist3 through
    nn_correspondences themselves).  K1, K3 and K4 launch on their own
    only in phase 2 and for the configurations the step does not carry.
 5. the fused cross-pair stream: the similar pool syn00-syn15 and the
    trimmed pool trm00-trm07, each prepared into one pool-max bucket
    (every pair's nearest-cell table checked as in phase 2), through
    register_fused_stream(width=2, chunk_steps=512).  Every pair is held
    against the port's register_device on the same prepared pair and,
    where there is one, against its fp32 reference row.  The inner step
    kernel (no torch body on the card), the rescoring kernel, rodrigues
    and the ICP kernel must have launched.  Then the trimmed pool
    once more with escalate_capacity =
    2 * trans_capacity after 1 chunk of 64 global iterations: at least
    one pair escalated, every pair converged, error within MSEThresh*Nd +
    1e-5 of the plain stream's.
 6. the slot-packed stream on the same pools:
    register_packed_stream(width=16, chunk_steps=512) with 16 slots and
    transitions every 8 iterations; the same checks, and the inner step
    kernel, the rescoring kernel, rodrigues and the ICP kernel must have
    launched again.
 7. the user's entry points, from files: a BO1-style data root written
    in a temporary directory (goicp_tpu_torch/bench/bo1_files.py) holding
    syn00, syn01, syn05, syn06, syn13 and syn07 as .mol2 cavities, c-FPFH
    files, the RMSD path's chain and aligned protein files, a pair list and
    a config.txt of GoICPConfig() + bench_shape.  The clouds and property
    codes read back from the files must equal the pools'.  Then, through
    goicp_tpu_torch.cli.main on the card: run-pair on syn07 with the device
    engine (held to its reference row and to register_device on the same
    prepared pair; output files written; RMSD near 0) and with the host
    engine (converged, error within MSEThresh*Nd of the row; rodrigues,
    rotate and rot_uncertainty launched by it, its outer step's rotations
    and rotated points and its inner searches' rotation uncertainty);
    run-bo1
    with the fused engine over the six pairs (each row equal in error and
    counters to phase 3's result, RMSD below 1e-3), with the device-batch
    engine (the compacting batch) over the six pairs (the same checks;
    then again: every pair skipped), with the host and device engines
    over two pairs (then again: both skipped); run-demo on
    a random 1000-point cloud and a rotated, shifted 500-point subset of
    it, on the demo's 300^3 grid (converged).  The inner step kernel
    (no torch body on the card) and every kernel but K1, K3, K4 and the
    off-path products must have launched.
 8. the bench's own code at a smaller depth: bench/measure.py's similar
    pool of 16 pairs in 4 shape buckets and its trimmed pool of 8, no
    reference data, one timed pass each through the fused stream (width
    2, 512-step chunks), held to measure._check_parity (converged, the
    margin guard, the fp32 reference rows' errors and, on the similar pool,
    their counters); pairs/s and bound evaluations/s printed, and the
    pairs whose counters differ from their sweep383 rows (TPU runs).  The
    inner step kernel must have launched, the torch body not on the card.
 9. the compacting batch engine: phase 3's six similar pairs in one
    pool-max bucket and its four trimmed pairs in another (every nearest-
    cell table checked), each set through register_device_batch_compact
    (chunk_steps=256, pad_to=8); every pair equal to phase 3's
    register_device (outer, inner, evals, icp_runs, opt_comp; error to
    1e-5) and to its fp32 row.  The similar batch is stopped after one
    chunk (max_chunks=1, a checkpoint in a temporary directory) and
    resumed: every pair equal to the uninterrupted run.  The inner step
    kernel launches once per batched inner iteration: fewer times than
    the rows' inner iterations together.  Chunks, the widths the batch
    compacted through, and the launches are printed; K2 and the inner
    step must have launched, the torch body not on the card.
10. the multi-GPU engines (goicp_tpu_torch/dist, torch.distributed) on
    this one card, each part's ranks started by dist/spawn.run_ranks (the
    kernels the parent built, loaded): one rank over NCCL (a 1 x 1 mesh):
    register_device(syn07, mesh=) equal to phase 3's syn07 in error, R, t,
    opt_comp, outer, inner, evals and icp_runs; register_device_sharded
    (syn07, rebalance_every=4) converged within MSEThresh*Nd of phase 3,
    gap within it too; register_fused_stream(trm00-trm07, mesh=) every pair
    equal to phase 5's; register_device_batch_compact(mesh=) on phase 9's
    trimmed set every pair equal to phase 9's.  Then 2 and 4 ranks sharing
    the card over gloo (1 x n meshes; gloo carries the CUDA tensors of
    the collectives, NCCL refuses two ranks on one card):
    register_device(syn07, mesh=)
    equal to phase 3 in every field above, register_device_sharded at
    rebalance_every 1 and 4 and the straggler handoff of syn07's fused row
    after 90 global iterations each within MSEThresh*Nd of phase 3 with
    the gap within it, and dryrun_multichip(n).  The inner step kernel and
    K2 must have launched (every rank's counts summed).  Walls are of ranks
    sharing one card, not a scaling measurement.
11. the fork's error options (goicp_tpu_torch/bench/options.py: l1 =
    norm 1; fpfh = cfpfh 1 with regularizationFPFH 0.001 and seeded
    descriptors; nbr = regularizationNeighbors 0.001), each on its 4
    similar and 2 trimmed bench pairs through register_device, each equal
    to its row of goicp_tpu_torch/bench/option_rows.jsonl (the JAX
    package's register_device on XLA:CPU): error and the rescored terms
    (geom, incomp, fpfh, nbr) within 1e-4, counters exact on similar
    pairs, evals within 5 % on trimmed ones.  The host engine on each
    option's first pair (unpadded), equal to the JAX host engine's result
    in the pair's row: counters exact, error and terms within 1e-4.  Over
    each option's similar pairs in one bucket: the fused stream (width 2)
    and the compacting batch (l1 on the step kernel, fpfh and nbr row by
    row), every pair equal to register_device; the packed stream refuses
    fpfh and nbr; the stream's ms per global iteration.  Then the CLI's
    run-pair on a BO1-style root with seeded descriptor files under one
    config of norm=1, cfpfh=1, regularizationFPFH and
    regularizationNeighbors: a non-zero FPFH term, equal to
    register_device on the same prepared pair.  Every kernel but K3, K4
    and the off-path products must have launched (K1 by the c-FPFH and
    neighbour options' torch body).  After the phase's launches are read:
    the fused
    stream's inner step alone (ms and kernel launches of every kernel,
    torch.profiler) on each path.

12. the BO1-scale sweep tool (goicp_tpu_torch/tools/sweep383.py) at a
    smaller depth: a subprocess runs `python -m
    goicp_tpu_torch.tools.sweep383 --no-reference --n 16
    --kill-after-chunks 2` (syn00-syn15 in its shape buckets), which must
    exit 3 and leave its stream's checkpoint under its exact name in the
    checkpoint directory; the same sweep then resumes in this process,
    and `--trimmed --n 8` runs uninterrupted.  Every row equals phase 5's
    fused stream on the same pair (error within 1e-5; similar: outer,
    evals, icp_runs and compat exact; trimmed: evals within 5 %) and its
    fp32 row; no checkpoint file is left.  K2 and the inner step kernel
    must have launched in the phase, the torch body not on the card.
13. one answer on both devices: every bench pair (syn00-syn63,
    trm00-trm31) prepared on the card and on the CPU in this process,
    the two prepared pairs equal bit for bit, then on each device
    initial_error, rodrigues of 8 seeded rotations and the data rotated
    by them, one ICP event from the identity and 4 seeded starts with
    its rescoring, and score_transform at the 8 rotations: the card's
    results equal the CPU's bit for bit.  Then syn72's register_device on
    the card, equal in every counter and every float32 bit to the row
    the port wrote on the CPU (goicp_tpu_torch/bench/cpu_rows.jsonl,
    `python -m goicp_tpu_torch.bench.cpu_rows --write`); the inner step
    kernel (no torch body on the card), K2, the rescoring kernel,
    rodrigues and the ICP kernel must have launched.  Last, the
    kernel launches of one global iteration's inner step, of one
    register_device inner iteration and of one ICP iteration
    (goicp_tpu_torch/bench/launch_counts.py) beside those of the
    trees before the fixed order (commit 1025156) and before the ICP
    kernel (ce5be19), those of one rescoring (one launch; 85 on
    c0016a3) and of an improving step's refinement, of a fused-stream
    transition of 8 rows (at most 2 launches and 1 host read) and of a
    register_device outer step (at most 4 launches) beside the trees
    before the transition kernel (789170e) and before advance was one
    launch (fd41384), and an ICP event's: one launch of csrc/icp.cu and
    no host read; one rodrigues and one rot_uncertainty, one launch each,
    and a host-engine outer step, beside the tree before they were one
    launch each (5157d79).

The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda:0"
SIMILAR = ["syn00", "syn01", "syn05", "syn06", "syn13", "syn07"]
DEMO_POINTS = (1000, 500)   # phase 7's demo: model and data points
TRIMMED = ["trm00", "trm01", "trm03", "trm13"]
STREAM_SIMILAR = [f"syn{i:02d}" for i in range(16)]
STREAM_TRIMMED = [f"trm{i:02d}" for i in range(8)]
ERR_TOL = 1e-4          # |error - reference error|
STREAM_ERR_TOL = 1e-5   # |stream error - register_device error|
TRIM_EVALS_REL = 0.05   # trimmed pairs: evals within 5 % of the reference
# goicp_tpu_torch/bench/launch_counts.py on the tree before the fixed
# float32 order (commit 1025156), on the H100 in the same call as this
# tree's first whole run: kernel launches of one global iteration's inner
# step (two live rows) and of one ICP iteration (four seeds)
BEFORE_FIXED_ORDER_LAUNCHES = {"global_iteration": 131.0,
                               "icp_iteration": 1006.0}
# the same on the tree before the ICP kernel (commit ce5be19, PERF.md)
BEFORE_ICP_KERNEL_LAUNCHES = {"global_iteration": 131.0,
                              "icp_iteration": 1004.0}
# launch_counts.py on the tree before rotate, norm3 and sincos32 were one
# launch each (commit 90724d7), on the H100 in one call with this tree:
# one outer transition (device_engine._pop) and one rescoring
# (score_transform at 4 transforms)
BEFORE_FUSED_ORDER_LAUNCHES = {"outer transition": 72.0, "rescoring": 89.0}
# launch_counts.py on the tree before the transition kernel (commit
# 789170e), on the H100 in one call with this tree (in turns): a
# fused-stream transition of 8 rows and a register_device outer step
# (syn07, 3 steps in)
BEFORE_TRANSITION_KERNEL = {
    "transition": "1177 launches, 40 host reads, 145 syncs",
    "outer_step": "366 launches (360 besides its 6 inner iterations), "
                  "24 host reads, 31 syncs"}
# the same on the tree before the inner run (commit 9dad47d, PERF.md
# §5): a register_device outer step (syn07, 3 steps in)
BEFORE_INNER_RUN = {
    "outer_step": "67 launches (61 besides its 6 inner iterations), 9 host "
                  "reads, 10 syncs"}
# the same on the tree before advance was one launch (commit fd41384,
# PERF.md §5): a fused-stream transition of 8 rows and a register_device
# outer step (syn07, 3 steps in)
BEFORE_ONE_LAUNCH_ADVANCE = {
    "transition": "3 launches, 0 host reads, 1 sync",
    "outer_step": "5 launches (4 besides its inner search's 1), 0 host "
                  "reads, 1 sync"}
# the same on the tree before rodrigues and rot_uncertainty were one
# launch each (commit 5157d79, PERF.md §5), on the H100 in one call with
# this tree (in turns): one rodrigues of 8 centres, one rot_uncertainty
# of 8 widths and the host engine's first outer step on syn07 (the lanes
# the engine passes, the root's 8 children)
BEFORE_ONE_LAUNCH_ROTATION = {
    "rodrigues": "26 launches", "rot_uncertainty": "7 launches",
    "host_outer_step": "65 launches, 1 host read, 5 syncs"}
# the fixed-order products of utils/fp32.py (csrc/fp32_products.cu)
FIXED_ORDER_PRODUCTS = ("sq_dist3", "det3", "cross3", "dot_fma")
# the fixed-order functions that take neighbouring torch ops into one
# launch each (utils/fp32.py; rodrigues_kernel is geom/rotation.py's
# rodrigues on the card, rot_uncertainty_kernel bounds/evaluate.py's
# rot_uncertainty): name -> source
FUSED_ORDER = {"rotate": "goicp_tpu_torch/csrc/ordered_sum.cu",
               "norm3": "goicp_tpu_torch/csrc/fp32_products.cu",
               "sincos32": "goicp_tpu_torch/csrc/fp32_products.cu",
               "rodrigues_kernel": "goicp_tpu_torch/csrc/fp32_products.cu",
               "rot_uncertainty_kernel":
                   "goicp_tpu_torch/csrc/fp32_products.cu"}
# the same on the tree before the rescoring was one launch (commit
# c0016a3, PERF.md §5): one rescoring (score_transform at 4 transforms)
BEFORE_ONE_LAUNCH_RESCORING = {"rescoring": "85 launches"}
# the same on the tree before the pick was one launch (commit ab7a9ff,
# PERF.md §5), on the H100 in one call with this tree (in turns): an
# improving step's refinement (launch_counts.py refine: the ICP event
# from 4 seeds, its rescoring, the pick by 0-d indices, the candidate's
# count, the refine block made and written) and the initial incumbent
BEFORE_ONE_LAUNCH_PICK = {"refine": "21 launches and 9 host reads",
                          "initial": "19 launches"}
# the same on the tree before the refine route (commit cdb6064, PERF.md
# §5-6, on the H100): an improving step's refinement, and the
# refinement of a fused-stream window's two rows (launch_counts.py
# refine_window: three launches a row)
BEFORE_REFINE_ROUTE = {"refine": "3 launches, 0 host reads, 0.271-0.273 ms "
                                 "on the host clock",
                       "refine_window": "6 launches, 0 host reads"}
# what every registration launches besides the bound kernels: the ICP
# events with their ends (csrc/icp.cu: icp_init, the initial incumbent's
# events from the initial seeds, their rescoring, the initial error and
# the pick into the state; icp_refine, every improving step's refinement
# with its seeds, rescoring and pick, which writes the refine record);
# norm3 and the ordered sum where a pair is prepared (phase 3's window
# holds the preparation; the ordered sum builds its c-FPFH table,
# PREP_SUMS); the ICP event alone (icp_run), rodrigues, rotate,
# rot_uncertainty and the rescoring (csrc/score.cu's goicp_score: the
# initial error, the ICP's scores, the BnB count) in every host-engine
# registration (its outer step's rotations and rotated points, its inner
# searches' rotation uncertainty, its refinements).  The products whose
# callers (the plain ICP loop; norm3 before it was one launch; rodrigues
# and rot_uncertainty before they were one launch each) no longer run on
# the card launch 0 times on the main path; so do the rescoring and the
# event alone, and rodrigues at most once a process (the initial ICP's
# seeds, kept).  The seeds', the pick's and the initial pick's own
# launches (REFINED_AWAY) are phase 2's only: the refine route took the
# first two into the ICP event's launch, the initial route the third.
PATH_KERNELS = ("icp_refine", "icp_init")
REFINED_AWAY = ("icp_seeds", "score_pick", "score_initial")
PREP_KERNELS = ("norm3", "ordered_sum")
HOST_ENGINE_KERNELS = ("rodrigues_kernel", "rotate", "rot_uncertainty_kernel",
                       "score_kernel", "icp_run")
OFF_PATH = ("sq_dist3", "det3", "cross3", "dot_fma", "sincos32")
CHECK_ONLY = ("kabsch3",)   # the ICP kernel's Kabsch alone: phase 2 only
# K1, K3 and K4, whose bodies run inside the inner step kernel
# (csrc/inner.cu) on the main path: their own launches are phase 2's and
# those of the configurations the step does not carry (phase 3's two-phase
# chem, phase 11's c-FPFH and neighbour terms)
IN_STEP = ("geometric_bounds_kernel", "geometric_bounds_kernel_lanes",
           "chem_incomp_kernel_lanes")


def ICP_OPS(nd, m):
    """Operations of one ICP iteration of a row (csrc/icp.cu): the NN
    search 9 a (point, model point) pair (a dot3 5, the distance 3, the
    compare 1); per point the rotation 18, |p|^2 5, the 7 masked sums 14
    and H's 9 sums of 6; the Kabsch ~KABSCH_OPS."""
    return 9 * nd * m + (18 + 5 + 14 + 54) * nd + KABSCH_OPS


# a Kabsch (kabsch_from_H): 18 Givens rotations of 68 operations, sigma
# 21, U 9, the completion 28, the determinants 29, D U^T 9, R 45, max|H|
# and the scaling 18
KABSCH_OPS = 18 * 68 + 21 + 9 + 28 + 29 + 9 + 45 + 18
PEAK_OPS = 67e12        # H100 SXM fp32 outside the tensor cores, per second
PEAK_OPS_F64 = 34e12    # H100 SXM fp64 outside the tensor cores, per second
# (NVIDIA's H100 data sheet, SXM part)
PEAK_BYTES = 3.35e12    # H100 SXM device memory, bytes per second
# Operations the functions need per (lane, node or corner, real point):
#   voxelize      21  3 axes x (add, sub, mul, add, trunc, max, min)
#   table index    4  (z * S + y) * S + x
# K1/K3 then      21  squared distance to the one cell 8 (3 sub, 3 mul, 2
#                     add), sqrt 1, divide 1, weight 1, minus rot_unc 1,
#                     clamp 1, minus sqrt(3)/2 w 1, clamp 1, three squares
#                     3, three sums 3 (the plain mode has one sum, one
#                     square and the rot_unc pair fewer: 17)
# K2/K4 then      19  the 9-wide dot 17 (9 mul, 8 add), mask minus dot 1,
#                     the sum 1
# K1/K3 by (norm, fused); at norm 1 (the fork's L1 option) the squares
# go: fused 3 fewer, plain 1
GEOM_OPS = {(2, True): 46, (2, False): 42, (1, True): 43, (1, False): 41}
CHEM_OPS = 44


def _require(ok, what):
    """A failed check ends the run (a plain raise, kept under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _median_ms(fn, n=25):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, n=50, reps=7, warm_s=0.03):
    """Per-launch time of fn with the host taken out: n calls captured into
    one CUDA graph, the graph replayed for warm_s seconds and then reps
    times between CUDA events, the median replay divided by n."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:    # let the clocks come up
        graph.replay()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def _launches_memsets(fn, n=10):
    """(kernel launches, memsets) a call of fn, from torch.profiler's
    launch API events over n calls (after two, which may make a run's two
    output sets)."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    count = {e.key: e.count for e in events}
    launches = sum(count.get(k, 0) for k in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    memsets = sum(v for k_, v in count.items() if "emset" in k_
                  and k_.startswith("cuda"))
    return launches / n, memsets / n


def _in_turns(kern, library, n=25):
    """(kernel ms, library ms): _median_ms of each in turns, kernel,
    library, library, kernel, each the mean of its two turns, so that a
    drift of the clocks or the host weighs on both alike."""
    k1, l1, l2, k2 = (_median_ms(kern, n), _median_ms(library, n),
                      _median_ms(library, n), _median_ms(kern, n))
    return (k1 + k2) / 2, (l1 + l2) / 2


def _alternated(kern, library, rounds=10, n=25):
    """(kernel medians, library medians): _median_ms of each, alternated
    kernel, library, library, kernel, ... for `rounds` of each, so that a
    drift of the clocks or the host weighs on both alike."""
    ks, ls = [], []
    for r in range(rounds):
        pair = ((kern, ks), (library, ls))
        for fn, out in (pair if r % 2 == 0 else pair[::-1]):
            out.append(_median_ms(fn, n))
    return ks, ls


def _same_bits(got, want):
    """Every float32 of got equals want's bit for bit."""
    import torch
    return all(g.shape == w.shape and torch.equal(
        g.contiguous().view(torch.int32), w.contiguous().view(torch.int32))
        for g, w in zip(got, want))


# ordered_sum launches made inside the preparation's chem tables
# (pipeline/prepare.py::_chem_tables: the c-FPFH table, built at every
# preparation, over one zero bin without descriptors) since the launch
# counts were last zeroed: the only ordered sums of the default
# configuration's paths since the rescoring is one launch of csrc/score.cu
PREP_SUMS = {"launches": 0}


def _count_prep_sums():
    """Wrap prepare._chem_tables and cuda_eval.reset_launch_counts so that
    PREP_SUMS counts the preparation's ordered_sum launches and is zeroed
    with the launch counts."""
    from goicp_tpu_torch.bounds import cuda_eval
    from goicp_tpu_torch.pipeline import prepare
    from goicp_tpu_torch.utils import fp32
    chem_tables, reset = prepare._chem_tables, cuda_eval.reset_launch_counts

    def counted(*args, **kw):
        before = fp32.ordered_sum.launches
        out = chem_tables(*args, **kw)
        PREP_SUMS["launches"] += fp32.ordered_sum.launches - before
        return out

    def zeroed():
        reset()
        PREP_SUMS["launches"] = 0
    prepare._chem_tables, cuda_eval.reset_launch_counts = counted, zeroed


def _sums_in_prep(counts, where, others=None):
    """Every ordered_sum launch of `where` (the launch counts just read)
    was the preparation's: the default configuration's registrations,
    streams, batches and entry points launch none (their rescoring is
    csrc/score.cu).  others: what launches the rest in a phase that runs
    other configurations (printed, not required)."""
    n, prep = counts["ordered_sum"], PREP_SUMS["launches"]
    if others is None:
        _require(n == prep, f"ordered_sum launched only by the preparation "
                 f"in {where}: {n} launches, {prep} of them the "
                 f"preparation's")
    print(f"ordered_sum in {where}: {n} launches, {prep} of them the "
          f"preparation's c-FPFH table"
          + (f", {n - prep} {others}" if others else "; 0 on the path"),
          flush=True)


def _off_path(counts, where):
    """The products whose callers no longer run on the card launched 0
    times: every ICP event went through csrc/icp.cu, every norm through
    norm3's own kernel, every sine and cosine through rodrigues' and
    rot_uncertainty's."""
    _require(all(counts[k] == 0 for k in OFF_PATH),
             f"{', '.join(OFF_PATH)} launched 0 times in {where}: "
             f"{ {k: counts[k] for k in OFF_PATH} }")


def _pick_path(counts, where):
    """Every ICP event of `where` ended in its pick inside its own launch
    (csrc/icp.cu's refine and initial routes), `where` running no host
    engine: the rescoring kernel and the event alone (icp_run) launched
    no time, and rodrigues at most once (the initial ICP's seeds, made
    once a process); the seeds' and the picks' own kernels no time."""
    _require(counts["score_kernel"] == 0 and counts["icp_run"] == 0
             and counts["rodrigues_kernel"] <= 1,
             f"score_kernel and icp_run launched 0 times and "
             f"rodrigues_kernel at most once in {where} (every rescoring "
             f"and every event in a route's launch, the initial seeds "
             f"kept): {counts['score_kernel']}, {counts['icp_run']}, "
             f"{counts['rodrigues_kernel']}")
    _refined_away(counts, where)


def _refined_away(counts, where):
    """Every refinement of `where` was one launch of the refine route and
    every initial incumbent one of the initial route: the seeds', the
    pick's and score_initial's own kernels launched no time."""
    _require(all(counts[k] == 0 for k in REFINED_AWAY),
             f"{', '.join(REFINED_AWAY)} launched 0 times in {where} "
             f"(every refinement one launch of the refine route, every "
             f"initial incumbent one of the initial route): "
             f"{ {k: counts[k] for k in REFINED_AWAY} }")


def _step_path(counts, where, loop="inner_run"):
    """The inner kernel `loop` and the transition kernels launched, and
    neither the torch body nor the torch transition ran on the card since
    the counts were zeroed: every inner search of `where` ran in launches
    of csrc/inner.cu (inner_run: a whole search, or a stream's iterations
    up to a transition, in one launch, and inner_step then launched no
    time; inner_step: the packed stream's one launch an iteration), every
    outer transition went through csrc/transition.cu."""
    from goicp_tpu_torch.search import inner, transition
    body = inner.body_on_card["iterations"]
    _require(counts[loop] > 0 and body == 0,
             f"{loop} launched ({counts[loop]}) and the torch body ran no "
             f"iteration on the card ({body}) in {where}")
    if loop == "inner_run":
        _require(counts["inner_step"] == 0,
                 f"inner_step launched no time in {where} (every inner "
                 f"search a run): {counts['inner_step']}")
    rows = transition.plain_on_card["rows"]
    _require(counts["harvest"] > 0 and counts["advance"] > 0 and rows == 0,
             f"harvest ({counts['harvest']}) and advance "
             f"({counts['advance']}) launched and the torch transition ran "
             f"no row on the card ({rows}) in {where}")


def _max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _bound(n_points, ops_per_point, tensors):
    """(bound_ms, bound_by): the least time the card could take for
    n_points (lane, node or corner, real point) evaluations of this run's
    inputs and these input/output tensors."""
    t_ops = n_points * ops_per_point / PEAK_OPS
    t_bytes = _nbytes(*tensors) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _real_points(pair):
    """Real (unpadded) data points of a prepared pair."""
    return int((pair.data_mask > 0).sum())


def _check_table(pair, name):
    """Grid.nearest_cell of a prepared pair == the first-minimum argmin of
    nearest_occupied over all S^3 voxels."""
    import torch
    from goicp_tpu_torch.grid.edt import nearest_occupied
    g = pair.grid
    size = g.geom.size
    flat = torch.arange(size ** 3, device=g.cell_coords.device)
    vox = torch.stack([flat % size, (flat // size) % size,
                       flat // (size * size)], dim=1)
    _, want = nearest_occupied(vox, g.cell_coords, size)
    _require(g.nearest_cell.dtype == torch.int32
             and torch.equal(g.nearest_cell.long(), want),
             f"{name}: Grid.nearest_cell == nearest_occupied on all "
             f"{size}^3 voxels")


def _first_diff(a, b):
    """Where two arrays first differ, for a failure message."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return f"shapes {a.shape} and {b.shape}"
    diff = np.argwhere(a != b)
    if not len(diff):
        return "no difference"
    i = tuple(int(x) for x in diff[0])
    return f"first at {i}: {a[i]!r} vs {b[i]!r}"


@contextlib.contextmanager
def _returns(module, name):
    """Record what module.name returns while the block runs (the CLI looks
    its entry points up when it is called)."""
    fn = getattr(module, name)
    out = []

    def wrapper(*args, **kw):
        out.append(fn(*args, **kw))
        return out[-1]
    setattr(module, name, wrapper)
    try:
        yield out
    finally:
        setattr(module, name, fn)


SWEEP_KILL = 2           # phase 12: chunks before the requested stop


def _sweep_phase(stream_outs, dev):
    """Phase 12: the sweep tool, stopped in a subprocess and resumed here,
    then the trimmed pool; every row held to phase 5's fused stream
    (stream_outs) and to its fp32 row.  Returns the kernels' launch counts
    of the phase."""
    import tempfile
    import torch
    from goicp_tpu_torch.bench import measure
    from goicp_tpu_torch.bounds import cuda_eval
    from goicp_tpu_torch.tools import sweep383

    # the sweep holds each pair to its fp32 row itself (main returns 0
    # only after bench/measure._check_parity)
    rows = measure.fp32_rows()
    cuda_eval.reset_launch_counts()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for label, n, extra in (("similar", len(STREAM_SIMILAR), []),
                                ("trimmed", len(STREAM_TRIMMED),
                                 ["--trimmed"])):
            out, ck = f"{tmp}/{label}.jsonl", f"{tmp}/{label}.ckpt"
            argv = ["--no-reference", "--n", str(n), "--out", out,
                    "--ckpt", ck, *extra]
            if label == "similar":
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, "-m", "goicp_tpu_torch.tools.sweep383",
                     *argv, "--kill-after-chunks", str(SWEEP_KILL)],
                    cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                    capture_output=True, text=True, timeout=900)
                killed = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
                print(f"phase 12 {label} sweep stopped after {SWEEP_KILL} "
                      f"chunks in a subprocess: exit {proc.returncode} in "
                      f"{time.perf_counter() - t0:.3f} s; {ck}: {killed}; "
                      f"its last lines: "
                      f"{proc.stdout.strip().splitlines()[-2:]}", flush=True)
                _require(proc.returncode == 3,
                         f"the stopped sweep exits 3, not "
                         f"{proc.returncode}: {proc.stderr[-2000:]}")
                stream = [f for f in killed if f.endswith(".npz")
                          and not f.endswith(".done.npz")]
                _require(len(stream) == 1 and "manifest.json" in killed
                         and not [f for f in killed
                                  if f.endswith((".npz.npz", ".tmp"))],
                         f"one stream checkpoint under its exact name: "
                         f"{killed}")
            t0 = time.perf_counter()
            _require(sweep383.main(argv) == 0, f"the {label} sweep")
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            _require(not os.path.exists(ck),
                     f"the {label} sweep removed its checkpoints: "
                     f"{os.listdir(ck) if os.path.isdir(ck) else ck}")
            with open(out) as fh:
                got = [json.loads(line) for line in fh]
            want = stream_outs[(5, label)]
            _require(len(got) == n, f"{label} sweep: {len(got)} rows")
            for i, g in enumerate(got):
                name = g["pair"]
                w = dict(error=float(want.error[i]),
                         outer=int(want.outer_iters[i]),
                         evals=int(want.evals[i]),
                         icp_runs=int(want.icp_runs[i]),
                         compat=int(want.opt_comp[i]))
                _require(g["converged"]
                         and abs(g["error"] - w["error"]) <= STREAM_ERR_TOL,
                         f"sweep {name}: {g} vs phase 5 {w}")
                if label == "similar":
                    for k in ("outer", "evals", "icp_runs", "compat"):
                        _require(g[k] == w[k], f"sweep {name} {k}: {g[k]} "
                                 f"vs phase 5 {w[k]}")
                else:
                    _require(abs(g["evals"] - w["evals"])
                             <= TRIM_EVALS_REL * w["evals"],
                             f"sweep {name} evals {g['evals']} vs phase 5 "
                             f"{w['evals']}")
                _require(name in rows, f"sweep {name} has an fp32 row")
            resumed = "resumed, " if label == "similar" else ""
            print(f"phase 12 {label} sweep ({resumed}{n} pairs): "
                  f"{wall:.3f} s in this process; every row equals phase "
                  f"5's fused stream and, by the sweep's own gates, its "
                  f"fp32 row; no checkpoint left", flush=True)
    counts = cuda_eval.launch_counts()
    print(f"phase 12 wall {time.perf_counter() - t_phase:.3f} s; launches "
          f"during phase 12: {json.dumps(counts)}", flush=True)
    _require(counts["advance"] > 0,
             "advance (the root corners, K2's body) launched in phase 12")
    _step_path(counts, "phase 12")
    _sums_in_prep(counts, "phase 12")
    return counts


def _setup():
    """(cfg, cfg_t, pools): GoICPConfig() + bench_shape, its trimmed form,
    and the bench's synthetic pools by name."""
    import goicp_tpu_torch
    from goicp_tpu_torch.bench.measure import (TRIM_FRACTION, bench_shape,
                                               synthetic_pool,
                                               synthetic_pool_trimmed)
    cfg = bench_shape(goicp_tpu_torch.GoICPConfig())
    cfg_t = dataclasses.replace(cfg, trimFraction=TRIM_FRACTION,
                                trans_capacity=256)
    pools = {e[0]: e for e in synthetic_pool(64, seed=7)}
    pools.update({e[0]: e for e in synthetic_pool_trimmed(32, seed=23)})
    return cfg, cfg_t, pools


def _prepared(name, cfg, pools, dev):
    from goicp_tpu_torch.bench.measure import _normalized_synthetic
    from goicp_tpu_torch.pipeline.prepare import (make_count_dynamic,
                                                  prepare_pair)
    data, model, dp, mp = _normalized_synthetic(pools[name])
    return make_count_dynamic(prepare_pair(data, model, dp, mp, cfg,
                                           bucket=True, device=dev))


def _entry_points(cfg, pools, ref, phase3, dev):
    """Phase 7: the CLI's subcommands on files written from the pools, on
    the card.  Returns the kernels' launch counts of the phase."""
    import tempfile

    import numpy as np
    import torch
    from goicp_tpu_torch import cli
    from goicp_tpu_torch.bench.bo1_files import write_bo1_root, write_config
    from goicp_tpu_torch.bench.measure import (_normalized_synthetic,
                                               synthetic_aligned)
    from goicp_tpu_torch.bounds import cuda_eval
    from goicp_tpu_torch.chem.properties import codes_to_indices
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    from goicp_tpu_torch.io.xyz import write_normalized_cloud
    from goicp_tpu_torch.pipeline import demo, pair as pair_mod
    from goicp_tpu_torch.pipeline.prepare import prepare_pair
    from goicp_tpu_torch.search.device_engine import register_device

    cuda_eval.reset_launch_counts()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "bo1")
        aligned = synthetic_aligned(64)
        ids = write_bo1_root(root, [(n, *pools[n][1:], aligned[n])
                                    for n in SIMILAR])
        config = os.path.join(root, "config.txt")
        write_config(config, cfg)
        chains = os.path.join(root, "chains")
        refp = os.path.join(root, "ref_proteins")

        def cavity(cid):
            return os.path.join(root, "cavities", f"{cid}_cavity6.mol2")

        # the files hold the pools' pairs: the quantized clouds and the
        # property codes read back equal the pools' own
        for name, (src, tgt) in zip(SIMILAR, ids):
            inputs = pair_mod.load_pair_inputs(cavity(tgt), cavity(src), cfg,
                                               write_normalized=False)
            want = _normalized_synthetic(pools[name])
            for label, a, b in (
                    ("data cloud", inputs.src_n, want[0]),
                    ("model cloud", inputs.tgt_n, want[1]),
                    ("data props", codes_to_indices(inputs.src_props),
                     want[2]),
                    ("model props", codes_to_indices(inputs.tgt_props),
                     want[3])):
                _require(np.array_equal(a, b),
                         f"{name}: the {label} read back from the files == "
                         f"the pool's ({_first_diff(a, b)})")
        print(f"phase 7: wrote {len(ids)} pairs under a BO1-style root; the "
              "clouds and property codes read back equal the pools'",
              flush=True)

        # ---- run-pair, device engine, syn07 ----
        src7, tgt7 = ids[SIMILAR.index("syn07")]
        nd7 = len(pools["syn07"][1])

        def run_pair_argv(out, engine):
            return ["run-pair", cavity(tgt7), cavity(src7), str(nd7), config,
                    os.path.join(out, "output.txt"), "5", "--out-dir", out,
                    "--chains-dir", chains, "--ref-proteins-dir", refp,
                    "--engine", engine, "-q"]
        out_dev = os.path.join(tmp, "run_pair_device")
        t0 = time.perf_counter()
        with _returns(pair_mod, "run_pair") as res:
            _require(cli.main(run_pair_argv(out_dev, "device")) == 0,
                     "run-pair --engine device")
        wall = time.perf_counter() - t0
        dres = res[0]
        reg = dres.registration
        row = ref["syn07"]
        got = dict(error=reg.error, converged=reg.converged,
                   outer=reg.outer_steps, evals=reg.bound_evals,
                   icp_runs=reg.icp_runs, compat=reg.compatibilities,
                   rmsd=dres.rmsd)
        _require(reg.converged, "run-pair device syn07 converged")
        _require(abs(reg.error - row["error"]) <= ERR_TOL,
                 f"run-pair device syn07 error {reg.error} vs reference "
                 f"row {row['error']}")
        for k in ("outer", "evals", "icp_runs"):
            _require(got[k] == row[k], f"run-pair device syn07 {k} "
                     f"{got[k]} vs reference row {row[k]}")
        inputs = pair_mod.load_pair_inputs(cavity(tgt7), cavity(src7), cfg,
                                           write_normalized=False)
        same = prepare_pair(inputs.src_n, inputs.tgt_n, inputs.src_props,
                            inputs.tgt_props, cfg, nd_downsampled=nd7,
                            bucket=True, device=dev)
        r = register_device(same, cfg)
        want = dict(error=float(r.error), outer=int(r.outer_iters),
                    evals=int(r.evals), icp_runs=int(r.icp_runs),
                    compat=nd7 - int(r.opt_comp))
        _require(abs(got["error"] - want["error"]) <= STREAM_ERR_TOL
                 and all(got[k] == want[k]
                         for k in ("outer", "evals", "icp_runs", "compat")),
                 f"run-pair device syn07 {got} vs register_device on the "
                 f"same prepared pair {want}")
        for f in ("output.txt", "output_rescaled.txt",
                  f"cavitiesN/{src7}_cavity6_sim5N.xyz",
                  f"cavitiesN/{tgt7}_cavity6_sim5N.xyz",
                  f"rot/rot_{src7}_protein.mol2", "resultsRMSD.txt"):
            _require(os.path.exists(os.path.join(out_dev, f)),
                     f"run-pair wrote {f}")
        _require(dres.rmsd is not None and dres.rmsd < 1e-3,
                 f"run-pair device syn07 RMSD {dres.rmsd}")
        print(f"run-pair syn07 --engine device: command {wall:.3f} s, "
              f"registration {reg.time_s:.3f} s | {json.dumps(got)} | "
              f"register_device on the same prepared pair "
              f"{json.dumps(want)}", flush=True)

        # ---- run-pair, host engine, syn07 ----
        t0 = time.perf_counter()
        before = cuda_eval.launch_counts()
        with _returns(pair_mod, "run_pair") as res:
            _require(cli.main(run_pair_argv(os.path.join(tmp, "host"),
                                            "host")) == 0,
                     "run-pair --engine host")
        wall = time.perf_counter() - t0
        host_launches = {k: v - before[k]
                         for k, v in cuda_eval.launch_counts().items()}
        for kname in HOST_ENGINE_KERNELS:
            _require(host_launches[kname] > 0,
                     f"{kname} launched by run-pair --engine host: "
                     f"{host_launches[kname]}")
        hreg = res[0].registration
        eps = cfg.MSEThresh * nd7
        _require(hreg.converged and abs(hreg.error - row["error"]) <= eps,
                 f"run-pair host syn07: converged {hreg.converged}, error "
                 f"{hreg.error} vs row {row['error']} (eps {eps})")
        print(f"run-pair syn07 --engine host: command {wall:.3f} s, "
              f"registration {hreg.time_s:.3f} s, error {hreg.error:.6g} "
              f"(row {row['error']}, eps {eps:.3g}), RMSD {res[0].rmsd:.3g}; "
              f"outer steps {hreg.outer_steps}, evals {hreg.bound_evals}, "
              f"ICP runs {hreg.icp_runs} (the device engine: "
              f"{reg.outer_steps}, {reg.bound_evals}, {reg.icp_runs}); "
              f"launches {json.dumps(host_launches)}", flush=True)

        # ---- run-bo1 ----
        def bo1(engine, out, *extra):
            t0 = time.perf_counter()
            _require(cli.main(["run-bo1", root, config, "--out-dir", out,
                               "--engine", engine, "-q", *extra]) == 0,
                     f"run-bo1 --engine {engine}")
            with open(os.path.join(out, "results_similar.jsonl")) as fh:
                return [json.loads(x) for x in fh], time.perf_counter() - t0

        def same_as_phase3(r, engine):
            name = r["source"][:-1]
            w = phase3[name]
            _require(r.get("converged") and
                     abs(r["error"] - w["error"]) <= STREAM_ERR_TOL
                     and r["outer_steps"] == w["outer"]
                     and r["bound_evals"] == w["evals"]
                     and r["icp_runs"] == w["icp_runs"]
                     and r["compatibilities"] == w["n_data"] - w["opt_comp"],
                     f"run-bo1 {engine} {name}: row {r} vs phase 3 {w}")
            _require(r["rmsd"] is not None and r["rmsd"] < 1e-3,
                     f"run-bo1 {engine} {name}: RMSD {r['rmsd']}")

        out_fused = os.path.join(tmp, "bo1_fused")
        rows, wall = bo1("fused", out_fused)
        _require(len(rows) == len(SIMILAR), f"run-bo1 fused: {len(rows)} "
                 f"rows for {len(SIMILAR)} pairs")
        for r in rows:
            same_as_phase3(r, "fused")
        print(f"run-bo1 --engine fused, {len(rows)} pairs: command "
              f"{wall:.3f} s, stream wall {rows[0]['batch_wall_s']:.3f} s "
              f"(batch {rows[0]['batch']}); every row equals phase 3 in "
              f"error and counters; max RMSD "
              f"{max(r['rmsd'] for r in rows):.3g}", flush=True)
        out_batch = os.path.join(tmp, "bo1_device_batch")
        rows, wall = bo1("device-batch", out_batch)
        _require(len(rows) == len(SIMILAR), f"run-bo1 device-batch: "
                 f"{len(rows)} rows for {len(SIMILAR)} pairs")
        for r in rows:
            same_as_phase3(r, "device-batch")
            _require(r["engine"] == "device-batch",
                     f"run-bo1 device-batch: engine {r['engine']}")
        again, wall2 = bo1("device-batch", out_batch)
        _require(len(again) == len(SIMILAR), "run-bo1 device-batch: the "
                 "second call skips every pair")
        print(f"run-bo1 --engine device-batch, {len(rows)} pairs: command "
              f"{wall:.3f} s, batch walls "
              f"{sorted({round(r['batch_wall_s'], 3) for r in rows})} s "
              f"(batches {sorted({r['batch'] for r in rows})}); every row "
              f"equals phase 3 in error and counters; again {wall2:.3f} s, "
              f"every pair skipped", flush=True)
        for engine in ("host", "device"):
            out = os.path.join(tmp, f"bo1_{engine}")
            rows, wall = bo1(engine, out, "--limit", "2")
            _require(len(rows) == 2 and not any("failed" in r for r in rows),
                     f"run-bo1 {engine} --limit 2: rows {rows}")
            for r in rows:
                if engine == "device":
                    same_as_phase3(r, engine)
                else:
                    w = ref[r["source"][:-1]]
                    _require(r["converged"] and abs(r["error"] - w["error"])
                             <= cfg.MSEThresh * phase3[r["source"][:-1]]
                             ["n_data"], f"run-bo1 host: row {r}")
            again, wall2 = bo1(engine, out, "--limit", "2")
            _require(len(again) == 2, f"run-bo1 {engine}: the second call "
                     "skips both pairs")
            print(f"run-bo1 --engine {engine} --limit 2: command {wall:.3f} "
                  f"s; again {wall2:.3f} s, both skipped", flush=True)

        # ---- run-demo: a random cloud and a rigidly moved subset ----
        rng = np.random.default_rng(1000)
        nm, nd = DEMO_POINTS
        model = rng.uniform(-0.7, 0.7, (nm, 3))
        # a rotation ICP from the identity does not undo: the search takes
        # some tens of outer steps (with angles up to 2.5 rad, ~100)
        data = (model[:nd] - rng.uniform(-0.1, 0.1, 3)) @ rodrigues_np(
            rng.uniform(-0.9, 0.9, 3))
        for f, cloud in (("model.txt", model), ("data.txt", data)):
            write_normalized_cloud(os.path.join(tmp, f), cloud)
        t0 = time.perf_counter()
        with _returns(demo, "run_demo") as res:
            _require(cli.main(["run-demo", os.path.join(tmp, "model.txt"),
                               os.path.join(tmp, "data.txt"), "--output",
                               os.path.join(tmp, "demo_output.txt"),
                               "-q"]) == 0, "run-demo")
        wall = time.perf_counter() - t0
        dem = res[0]
        _require(dem.converged, f"run-demo converged ({dem})")
        print(f"run-demo, {nm} model / {nd} data points, S="
              f"{demo.DEMO_CONFIG.distTransSize}, device engine: command "
              f"{wall:.3f} s, registration {dem.time_s:.3f} s, error "
              f"{dem.error:.6g}, outer steps {dem.outer_steps}, evals "
              f"{dem.bound_evals}, ICP runs {dem.icp_runs}", flush=True)

    counts = cuda_eval.launch_counts()
    print(f"phase 7 wall {time.perf_counter() - t_phase:.3f} s; launches "
          f"during phase 7: {json.dumps(counts)}", flush=True)
    for kname in counts:
        _require(counts[kname] > 0
                 or kname in OFF_PATH + CHECK_ONLY + IN_STEP + REFINED_AWAY
                 + ("inner_step",),
                 f"{kname} launched in phase 7")
    _refined_away(counts, "phase 7")
    _step_path(counts, "phase 7")
    _off_path(counts, "phase 7")
    _sums_in_prep(counts, "phase 7")
    return counts


def _knob_phase(cfg, pair, full):
    """Phase 3's additions: syn07 (its phase-3 pair and result `full`) with
    the knobs that change how the search works, never what it finds
    (sorted_merge, chem_survivors at the full budget: the same result and
    counters), and with a chem budget of 8 (sound: an achievable
    incumbent, a valid gap).  Returns the kernels' launch counts."""
    import torch
    from goicp_tpu_torch.bounds import cuda_eval
    from goicp_tpu_torch.search.device_engine import register_device

    cuda_eval.reset_launch_counts()
    for label, c in (
            ("sorted_merge=1", dataclasses.replace(cfg, sorted_merge=1)),
            (f"chem_survivors={8 * cfg.trans_pop} (every child)",
             dataclasses.replace(cfg, chem_survivors=8 * cfg.trans_pop))):
        t0 = time.perf_counter()
        r = register_device(pair, c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _require(float(r.error) == float(full.error)
                 and torch.equal(r.R, full.R) and torch.equal(r.t, full.t),
                 f"syn07 {label}: error {float(r.error)!r}, R, t == phase "
                 f"3's ({float(full.error)!r})")
        for f in ("opt_comp", "evals", "outer_iters", "inner_iters",
                  "geom_surv"):
            _require(int(getattr(r, f)) == int(getattr(full, f)),
                     f"syn07 {label}: {f} {int(getattr(r, f))} == phase "
                     f"3's {int(getattr(full, f))}")
        print(f"phase 3, syn07 {label}: register {wall:.3f} s; error, R, t, "
              f"opt_comp, evals, outer, inner, geom_surv equal phase 3's "
              f"(chem corners {int(r.chem_corners)}, phase 3 "
              f"{int(full.chem_corners)})", flush=True)
    # a small budget prunes weakly: capped at twice the lattice run's steps
    c8 = dataclasses.replace(cfg, chem_survivors=8,
                             max_outer_steps=2 * int(full.outer_iters))
    t0 = time.perf_counter()
    r = register_device(pair, c8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eps = cfg.MSEThresh * _real_points(pair)
    _require(float(r.error) >= float(full.error) - eps - 1e-5
             and float(r.gap) >= -1e-5,
             f"syn07 chem_survivors=8: error {float(r.error)} >= "
             f"{float(full.error)} - {eps} - 1e-5, gap {float(r.gap)} >= 0")
    print(f"phase 3, syn07 chem_survivors=8 (max_outer_steps "
          f"{c8.max_outer_steps}): register {wall:.3f} s, converged "
          f"{bool(r.converged)}, error {float(r.error):.6g} (full budget "
          f"{float(full.error):.6g}, eps {eps:.3g}), gap {float(r.gap):.4g}, "
          f"outer {int(r.outer_iters)}, evals {int(r.evals)}, chem corners "
          f"per inner iteration "
          f"{int(r.chem_corners) / max(int(r.inner_iters), 1):.1f} (full "
          f"budget {int(full.chem_corners) / max(int(full.inner_iters), 1):.1f})",
          flush=True)
    counts = cuda_eval.launch_counts()
    print(f"launches during phase 3's additions: {json.dumps(counts)}",
          flush=True)
    _sums_in_prep(counts, "phase 3's additions",
                  others="outside it (the two-phase chem's torch body)")
    return counts


def _batch_phase(cfg, cfg_t, pools, ref, phase3, dev):
    """Phase 9: the compacting batch engine on the card.  Phase 3's six
    similar pairs in one pool-max bucket, then its four trimmed pairs,
    through register_device_batch_compact(chunk_steps=256, pad_to=8), each
    pair held to phase 3's register_device and to its fp32 row; then the
    similar batch stopped after one chunk and resumed from its checkpoint.
    Returns the kernels' launch counts of the phase and each set's result
    ({"similar": ..., "trimmed": ...})."""
    import tempfile

    import torch
    from goicp_tpu_torch.bench.measure import (_bucket_and_prepare,
                                               _normalized_synthetic)
    from goicp_tpu_torch.bounds import cuda_eval
    from goicp_tpu_torch.search import chunked

    cuda_eval.reset_launch_counts()
    t_phase = time.perf_counter()
    counters = ("outer", "inner", "evals", "icp_runs", "opt_comp")
    outs = {}

    def got_of(out, i):
        return dict(error=float(out.error[i]),
                    converged=bool(out.converged[i]),
                    outer=int(out.outer_iters[i]),
                    inner=int(out.inner_iters[i]), evals=int(out.evals[i]),
                    icp_runs=int(out.icp_runs[i]),
                    opt_comp=int(out.opt_comp[i]))

    for label, names, c in (("similar", SIMILAR, cfg),
                            ("trimmed", TRIMMED, cfg_t)):
        pairs = _bucket_and_prepare(
            [_normalized_synthetic(pools[n]) for n in names], c, device=dev)
        for n, p in zip(names, pairs):
            _check_table(p, f"{n} (phase 9's {label} bucket)")
        chunked.reset_counters()
        before = cuda_eval.launch_counts()
        t0 = time.perf_counter()
        out = chunked.register_device_batch_compact(pairs, c, chunk_steps=256,
                                                    pad_to=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs[label] = out
        launched = {k: v - before[k]
                    for k, v in cuda_eval.launch_counts().items()}
        widths = list(chunked.counters["widths"])
        for i, name in enumerate(names):
            got, want, row = got_of(out, i), phase3[name], ref[name]
            _require(got["converged"]
                     and abs(got["error"] - want["error"]) <= STREAM_ERR_TOL
                     and all(got[k] == want[k] for k in counters),
                     f"batch {name}: {got} vs phase 3's register_device "
                     f"{want}")
            _require(abs(got["error"] - row["error"]) <= ERR_TOL,
                     f"batch {name}: error {got['error']} vs reference row "
                     f"{row['error']}")
            if name.startswith("syn"):
                _require(all(got[k] == row[k] for k in
                             ("outer", "inner", "evals", "icp_runs")),
                         f"batch {name}: {got} vs reference row {row}")
            else:
                _require(abs(got["evals"] - row["evals"])
                         <= TRIM_EVALS_REL * row["evals"],
                         f"batch {name}: evals {got['evals']} vs reference "
                         f"row {row['evals']}")
        # one inner run launch per BATCHED outer step (every stepping
        # row's inner search in it): fewer than the rows' own outer steps
        # together, no fewer than the most of one row; no inner step
        inner = [int(x) for x in out.inner_iters]
        outer = [int(x) for x in out.outer_iters]
        k3 = launched["inner_run"]
        _require(max(outer) <= k3 < sum(outer)
                 and launched["inner_step"] == 0,
                 f"batch {label}: inner_run {k3} launches for the rows' "
                 f"outer steps {outer}, inner_step "
                 f"{launched['inner_step']}")
        print(f"phase 9 compacting batch, {label}: {len(pairs)} pairs padded "
              f"to 8 (Nd={pairs[0].n_data_padded}, C="
              f"{pairs[0].grid.cell_coords.shape[0]}): wall {wall:.3f} s, "
              f"{len(widths)} chunks at widths {widths}, "
              f"outer steps {[int(x) for x in out.outer_iters]}, inner "
              f"iterations {inner} (sum {sum(inner)}) in {k3} inner runs "
              f"(one a batched outer step); every pair "
              f"equals phase 3 (outer, inner, evals, icp_runs, opt_comp; "
              f"error to 1e-5) and its fp32 row; launches "
              f"{json.dumps(launched)}", flush=True)
        if label != "similar":
            continue
        # stopped after its first chunk, resumed from the checkpoint
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "batch.npz")
            t0 = time.perf_counter()
            try:
                chunked.register_device_batch_compact(
                    pairs, c, chunk_steps=256, pad_to=8, checkpoint_path=ck,
                    max_chunks=1)
                _require(False, "max_chunks=1 stops the similar batch")
            except RuntimeError as exc:
                _require("in flight" in str(exc), f"max_chunks=1: {exc}")
            resumed = chunked.register_device_batch_compact(
                pairs, c, chunk_steps=256, pad_to=8, checkpoint_path=ck,
                resume=True)
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t0
        for i, name in enumerate(names):
            a, b = got_of(resumed, i), got_of(out, i)
            _require(a == b, f"resumed batch {name}: {a} vs the "
                     f"uninterrupted run {b}")
        print(f"phase 9: the similar batch stopped after one chunk and "
              f"resumed from its checkpoint: {wall2:.3f} s, every pair "
              f"equal to the uninterrupted run", flush=True)
    counts = cuda_eval.launch_counts()
    print(f"phase 9 wall {time.perf_counter() - t_phase:.3f} s; launches "
          f"during phase 9: {json.dumps(counts)}", flush=True)
    _require(counts["advance"] > 0,
             "advance (the root corners, K2's body) launched in phase 9")
    _step_path(counts, "phase 9")
    _sums_in_prep(counts, "phase 9")
    return counts, outs


def _bench_phase(dev):
    """Phase 8: the bench's pools at a smaller depth, one timed pass each.
    Returns the kernels' launch counts of the phase."""
    import numpy as np
    import torch
    import goicp_tpu_torch
    from goicp_tpu_torch.bench import measure
    from goicp_tpu_torch.bounds import cuda_eval

    cfg = measure.bench_shape(goicp_tpu_torch.GoICPConfig())
    cfg_t = dataclasses.replace(cfg, trimFraction=measure.TRIM_FRACTION,
                                trans_capacity=256)
    rows = measure.reference_rows()
    cuda_eval.reset_launch_counts()
    t_phase = time.perf_counter()
    rates = {}
    for label, c, n, build in (
            ("similar", cfg, 16, lambda: measure.build_batch_buckets(
                cfg, 16, max_buckets=4, device=dev)),
            ("trimmed", cfg_t, 8, lambda: measure.build_trimmed_batch_buckets(
                cfg_t, 8, device=dev))):
        names = measure.similar_names(n) if label == "similar" else \
            [e[0] for e in measure.synthetic_pool_trimmed(n)]
        t0 = time.perf_counter()
        buckets = build()
        torch.cuda.synchronize()
        prep = time.perf_counter() - t0
        wall, out = measure.timed_pass(buckets, c, n, names, rows)
        evals = int(np.sum(out.evals))
        differ = measure.sweep_row_differences(out, names,
                                               measure.sweep_rows())
        rates[label] = (n / wall, evals / wall)
        print(f"phase 8 bench {label} pool: {n} pairs in {len(buckets)} "
              f"buckets (prepare {prep:.3f} s), one pass of the fused "
              f"stream {wall:.3f} s = {n / wall:.4f} pairs/s, {evals} "
              f"bound evaluations = {evals / wall:.1f} evals/s; "
              f"_check_parity held; counters other than the sweep383 rows' "
              f"(this run, row): {json.dumps(differ)}", flush=True)
    print(f"phase 8: pairs_per_s {rates['similar'][0]:.4f}, "
          f"trimmed_pairs_per_s {rates['trimmed'][0]:.4f}, "
          f"bound_evals_per_s {rates['similar'][1]:.1f} (the card's, at "
          f"this depth)", flush=True)
    counts = cuda_eval.launch_counts()
    print(f"phase 8 wall {time.perf_counter() - t_phase:.3f} s; launches "
          f"during phase 8: {json.dumps(counts)}", flush=True)
    _step_path(counts, "phase 8")
    _sums_in_prep(counts, "phase 8")
    return counts


# phase 10's parts: (label, ranks, backend)
PHASE10_PARTS = (("nccl", 1, "nccl"), ("gloo", 2, "gloo"), ("gloo", 4, "gloo"))
PHASE10_MID = 90        # global iterations of syn07's fused row before the
                        # handoff (phase 3: 186 inner iterations, 29 steps)
FIELDS = ("error", "R", "t", "opt_comp", "outer_iters", "inner_iters",
          "evals", "icp_runs", "converged", "gap")


def _fields(prefix, res):
    import torch
    return {f"{prefix}.{f}": torch.as_tensor(getattr(res, f)).cpu().numpy()
            for f in FIELDS}


def phase10_rank(device, part):
    """One rank of phase 10 (dist/spawn.run_ranks calls it in each rank's
    process, the process group joined).  part "nccl": the 1 x 1 mesh's
    runs; part "gloo": the 1 x n mesh's.  Returns every run's fields, the
    walls and the launch counts of this rank."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from goicp_tpu_torch.bench.measure import (_bucket_and_prepare,
                                               _normalized_synthetic)
    from goicp_tpu_torch.bounds import cuda_eval
    from goicp_tpu_torch.dist.dryrun import dryrun_multichip
    from goicp_tpu_torch.dist.mesh import make_mesh, stack_pairs
    from goicp_tpu_torch.search import fused_stream as fs
    from goicp_tpu_torch.search.chunked import register_device_batch_compact
    from goicp_tpu_torch.search.device_engine import register_device
    from goicp_tpu_torch.search.sharded_engine import register_device_sharded

    cfg, cfg_t, pools = _setup()
    n = dist.get_world_size()
    mesh = make_mesh(1, n, device=device)
    syn07 = _prepared("syn07", cfg, pools, device)
    out, walls = {}, {}
    cuda_eval.reset_launch_counts()

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        return res

    out.update(_fields("lane", timed("register_device", lambda: (
        register_device(syn07, cfg, mesh=mesh)))))
    if part == "nccl":
        out.update(_fields("sharded4", timed("sharded_k4", lambda: (
            register_device_sharded(syn07, cfg, mesh, rebalance_every=4)))))
        stream = _bucket_and_prepare(
            [_normalized_synthetic(pools[m]) for m in STREAM_TRIMMED], cfg_t,
            device=device)
        out.update(_fields("stream", timed("fused_stream", lambda: (
            fs.register_fused_stream(stream, cfg_t, width=2, chunk_steps=512,
                                     mesh=mesh)))))
        batch = _bucket_and_prepare(
            [_normalized_synthetic(pools[m]) for m in TRIMMED], cfg_t,
            device=device)
        out.update(_fields("compact", timed("compact_batch", lambda: (
            register_device_batch_compact(batch, cfg_t, chunk_steps=256,
                                          mesh=mesh)))))
    else:
        for k in (1, 4):
            out.update(_fields(f"sharded{k}", timed(f"sharded_k{k}", lambda: (
                register_device_sharded(syn07, cfg, mesh,
                                        rebalance_every=k)))))
        pb = stack_pairs([syn07])
        row = fs.fused_run_chunk(pb, cfg, fs._init_batch(pb, cfg),
                                 PHASE10_MID)
        out["mid_flight"] = not bool(row["converged"][0])
        out.update(_fields("handoff", timed("handoff", lambda: (
            fs.straggler_to_lane_sharded(syn07, cfg, fs._row(row, 0),
                                         mesh)))))
        # raises unless every engine gives finite errors
        timed("dryrun", lambda: dryrun_multichip(n, device=device))
    counts = cuda_eval.launch_counts()
    out["launch_names"] = np.array(sorted(counts))
    out["launches"] = np.array([counts[k] for k in sorted(counts)])
    out["wall_names"] = np.array(list(walls))
    out["walls"] = np.array(list(walls.values()))
    return out


def _multi_gpu_phase(cfg, syn07, phase3, stream5, batch9):
    """Phase 10: the multi-GPU engines on this one card (see the module
    docstring).  cfg: GoICPConfig() + bench_shape; syn07: phase 3's
    DeviceResult of syn07; stream5 / batch9:
    phase 5's fused stream and phase 9's compacting batch on the trimmed
    pairs.  Returns the kernels' launch counts of the phase, every rank's
    summed."""
    import numpy as np
    import torch
    from goicp_tpu_torch.dist.spawn import run_ranks

    t_phase = time.perf_counter()
    want = {f: torch.as_tensor(getattr(syn07, f)).cpu().numpy()
            for f in FIELDS}
    eps = cfg.MSEThresh * phase3["syn07"]["n_data"]
    counts = {}
    for label, n, backend in PHASE10_PARTS:
        t0 = time.perf_counter()
        outs = run_ranks("chip_smoke:phase10_rank", n, dict(part=label),
                         device=DEVICE, backend=backend, timeout_s=300)
        wall = time.perf_counter() - t0
        for out in outs:
            for k, v in zip(out["launch_names"], out["launches"]):
                counts[str(k)] = counts.get(str(k), 0) + int(v)
        for r, out in enumerate(outs):
            for f in FIELDS:
                _require(np.array_equal(out[f"lane.{f}"], want[f]),
                         f"phase 10 {backend} x{n} rank {r}: register_device"
                         f"(mesh=) {f} {out[f'lane.{f}']} vs phase 3 "
                         f"{want[f]}")
            runs = [k.split(".")[0] for k in out if k.startswith(
                ("sharded", "handoff")) and k.endswith(".error")]
            for run in runs:
                err, gap = float(out[f"{run}.error"]), float(out[f"{run}.gap"])
                _require(bool(out[f"{run}.converged"])
                         and abs(err - float(want["error"])) <= eps
                         and gap <= eps,
                         f"phase 10 {backend} x{n} rank {r} {run}: error "
                         f"{err}, gap {gap} vs phase 3 {want['error']} "
                         f"(eps {eps})")
            if label == "nccl":
                for run, ref in (("stream", stream5), ("compact", batch9)):
                    for f in FIELDS:
                        _require(np.array_equal(out[f"{run}.{f}"],
                                                np.asarray(getattr(ref, f))),
                                 f"phase 10 nccl {run} {f}: "
                                 + _first_diff(out[f"{run}.{f}"],
                                               getattr(ref, f)))
            else:
                _require(bool(out["mid_flight"]),
                         "syn07's fused row is mid-flight at the handoff")
        rank_walls = ", ".join(f"{k} {v:.3f} s" for k, v in zip(
            outs[0]["wall_names"], outs[0]["walls"]))
        summary = {k: outs[0][f"{k}.{f}"].tolist()
                   for k in ("sharded1", "sharded4", "handoff")
                   for f in ("outer_iters",) if f"{k}.{f}" in outs[0]}
        print(f"phase 10 {n} rank(s) over {backend} on one card: wall "
              f"{wall:.3f} s (process start included); rank 0: "
              f"{rank_walls}; outer steps {json.dumps(summary)}; checks "
              f"held", flush=True)
    print(f"phase 10 wall {time.perf_counter() - t_phase:.3f} s (ranks "
          f"sharing one card: no scaling number); launches during phase "
          f"10, every rank's summed: {json.dumps(counts)}", flush=True)
    for kname in ("inner_run", "harvest", "advance"):
        _require(counts.get(kname, 0) > 0, f"{kname} launched in phase 10")
    _require(counts.get("inner_step", 0) == 0,
             f"inner_step launched no time in phase 10: "
             f"{counts.get('inner_step')}")
    return counts


def _option_pairs(names, c, pools, dev, bucket="own"):
    """The named bench pairs with their seeded descriptors, prepared under
    c: bucket "own", each in its own bucket (count-dynamic); "shared", all
    in one pool-max bucket (count-dynamic, for a stream or a batch);
    "none", unpadded (for the host engine)."""
    from goicp_tpu_torch.bench.measure import _normalized_synthetic
    from goicp_tpu_torch.bench.options import seeded_descriptors
    from goicp_tpu_torch.pipeline.prepare import (bucket_dims,
                                                  make_count_dynamic,
                                                  prepare_pair)
    raws = []
    for n in names:
        raw = _normalized_synthetic(pools[n])
        raws.append(raw + seeded_descriptors(raw[2], raw[3]))
    if bucket == "none":
        return [prepare_pair(*r[:4], c, *r[4:], device=dev) for r in raws]
    dims: dict = {}
    if bucket == "shared":
        for r in raws:
            d = bucket_dims(r[1], len(r[0]), len(r[1]), c)
            dims = {k: max(dims.get(k, 0), v) for k, v in d.items()}
    return [make_count_dynamic(prepare_pair(
        *r[:4], c, *r[4:], bucket=bucket == "own", device=dev, **dims))
        for r in raws]


def _row_of(r, i=None):
    """A registration's row fields (of row i of a batched result)."""
    def at(v):
        return v if i is None else v[i]
    return dict(error=float(at(r.error)), converged=bool(at(r.converged)),
                outer=int(at(r.outer_iters)), inner=int(at(r.inner_iters)),
                evals=int(at(r.evals)), icp_runs=int(at(r.icp_runs)),
                compat=int(at(r.opt_comp)))


def _inner_step_cost(pairs, c, sync, n=50, n_prof=10):
    """The fused stream's inner step (one global iteration's inner-BnB
    step of a window of two live rows) on a state 3 global iterations into
    the search: its mean time over n calls (one synchronize at the end)
    and its kernel launches per call, every kernel counted (torch's and
    the port's), from torch.profiler's launch API events over n_prof
    calls.  The step does not change the state it is given."""
    import torch
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.search import fused_stream as fs

    pb = stack_pairs(pairs)
    state = fs.fused_run_chunk(pb, c, fs._init_batch(pb, c), 3)
    live = ~state["converged"] & ~fs._inner_complete(c, state)
    _require(bool(live.all()), "both rows live 3 global iterations in")
    tables = fs._window_tables(pb, c, state["inner"]["done"].shape[1])

    def step():
        return fs._inner_step(pb, c, state, tables, live)
    step()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    sync()
    ms = (time.perf_counter() - t0) / n * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n_prof):
            step()
        sync()
    names = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
    calls = sum(e.count for e in prof.key_averages() if e.key in names)
    return dict(step_ms=ms, step_launches=calls / n_prof)


def _options_phase(cfg, pools, dev):
    """Phase 11, the fork's error options (bench/options.py): see the
    module docstring.  Returns the kernels' launch counts of the phase."""
    import tempfile

    import torch
    from goicp_tpu_torch import cli
    from goicp_tpu_torch.bench import options
    from goicp_tpu_torch.bench.bo1_files import write_bo1_root, write_config
    from goicp_tpu_torch.bounds import cuda_eval
    from goicp_tpu_torch.bounds.error import score_transform
    from goicp_tpu_torch.bounds.evaluate import only_incomp
    from goicp_tpu_torch.icp.icp import nn_correspondences
    from goicp_tpu_torch.pipeline import pair as pair_mod
    from goicp_tpu_torch.pipeline.prepare import prepare_pair
    from goicp_tpu_torch.search import chunked, fused_stream, outer
    from goicp_tpu_torch.search.device_engine import register_device
    from goicp_tpu_torch.search.packed_stream import (register_packed_stream,
                                                      supports_packed)

    def sync():
        torch.cuda.synchronize()

    rows = options.option_rows()
    cuda_eval.reset_launch_counts()
    t_phase = time.perf_counter()
    singles = {}
    for option, names in options.OPTION_PAIRS.items():
        t_opt = time.perf_counter()
        for name in names:
            trimmed = name.startswith("trm")
            c = options.option_config(cfg, option, trimmed=trimmed)
            pair = _option_pairs([name], c, pools, dev)[0]
            r = register_device(pair, c)
            sync()
            got, row = _row_of(r), rows[(option, name)]
            _require(got["converged"], f"{option} {name} converged")
            _require(abs(got["error"] - row["error"]) <= ERR_TOL,
                     f"{option} {name} error {got['error']} vs option row "
                     f"{row['error']}")
            if trimmed:
                _require(abs(got["evals"] - row["evals"])
                         <= TRIM_EVALS_REL * row["evals"],
                         f"{option} {name} evals {got['evals']} vs option "
                         f"row {row['evals']}")
            else:
                for k in ("outer", "inner", "evals", "icp_runs", "compat"):
                    _require(got[k] == row[k], f"{option} {name} {k}: "
                             f"{got[k]} vs option row {row[k]}")
            idx, _ = nn_correspondences(pair.data @ r.R.T + r.t, pair.model)
            sc = score_transform(pair, c, r.R, r.t, idx)
            score = {k: float(getattr(sc, k)) for k in row["score"]}
            _require(all(abs(score[k] - v) <= ERR_TOL
                         for k, v in row["score"].items()),
                     f"{option} {name} rescored {score} vs option row "
                     f"{row['score']}")
            singles[(option, name)] = got
        print(f"phase 11 {option} ({json.dumps(options.OPTIONS[option])}): "
              f"{len(names)} pairs through register_device in "
              f"{time.perf_counter() - t_opt:.3f} s, each equal to its "
              f"option row: "
              + "; ".join(f"{n} {json.dumps(singles[(option, n)])} terms "
                          f"{rows[(option, n)]['terms']}" for n in names),
              flush=True)

        # the host engine on the option's cheapest pair (unpadded), held
        # to the JAX host engine's row
        name = names[0]
        c = options.option_config(cfg, option)
        hpair = _option_pairs([name], c, pools, dev, bucket="none")[0]
        t0 = time.perf_counter()
        h = outer.register(hpair, c)
        wall = time.perf_counter() - t0
        want = rows[(option, name)]["host"]
        for k, v in want.items():
            got = getattr(h, k)
            _require(abs(got - v) <= ERR_TOL if isinstance(v, float)
                     else got == v, f"host engine {option} {name} {k}: "
                     f"{got} vs option row {v}")
        print(f"phase 11 {option} {name}, the host engine: {wall:.3f} s, "
              f"equal to its option row: error {h.error!r} (register_device "
              f"{singles[(option, name)]['error']!r}), outer steps "
              f"{h.outer_steps}, evals {h.bound_evals}, icp_runs "
              f"{h.icp_runs}", flush=True)

    # the fused stream and the compacting batch over each option's similar
    # pairs: on the K3/K4 path (l1) and on the row-by-row path (fpfh, nbr)
    per_iter, step_pairs = {}, {}
    for option in options.OPTIONS:
        c = options.option_config(cfg, option)
        names = [n for n in options.OPTION_PAIRS[option]
                 if n.startswith("syn")]
        pairs = _option_pairs(names, c, pools, dev, bucket="shared")
        refs = [_row_of(register_device(p, c)) for p in pairs]
        _require(supports_packed(pairs[0], c) == only_incomp(c),
                 f"the packed stream refuses {option} exactly when K3/K4 do "
                 f"not carry its terms")
        if not only_incomp(c):
            try:
                register_packed_stream(pairs, c, width=2)
                _require(False, f"the packed stream refuses {option}")
            except ValueError as exc:
                _require("incomp-only" in str(exc), f"{option}: {exc}")
        for engine in ("fused", "batch"):
            fused_stream.reset_counters()
            before = cuda_eval.launch_counts()
            t0 = time.perf_counter()
            if engine == "fused":
                out = fused_stream.register_fused_stream(pairs, c, width=2,
                                                         chunk_steps=512)
            else:
                out = chunked.register_device_batch_compact(
                    pairs, c, chunk_steps=256, pad_to=len(pairs))
            sync()
            wall = time.perf_counter() - t0
            launched = {k: v - before[k]
                        for k, v in cuda_eval.launch_counts().items()}
            for i, name in enumerate(names):
                got = _row_of(out, i)
                _require(got["converged"] and abs(got["error"]
                                                  - refs[i]["error"])
                         <= STREAM_ERR_TOL
                         and all(got[k] == refs[i][k] for k in
                                 ("outer", "evals", "icp_runs", "compat")),
                         f"{option} {engine} {name}: {got} vs "
                         f"register_device {refs[i]}")
                _require(abs(got["error"] - rows[(option, name)]["error"])
                         <= ERR_TOL, f"{option} {engine} {name}: error "
                         f"{got['error']} vs option row")
            msg = (f"phase 11 {option} {engine}: {len(pairs)} pairs in one "
                   f"bucket (Nd={pairs[0].n_data_padded}), wall {wall:.3f} "
                   f"s, every pair equal to register_device; launches "
                   f"{json.dumps(launched)}")
            if engine == "fused":
                g = fused_stream.counters["global_iters"]
                per_iter[option] = dict(
                    path="step kernel" if only_incomp(c) else "row by row",
                    global_iters=g, wall_ms=wall / g * 1e3)
                step_pairs[option] = (pairs[1:3], c)
                msg += (f"; {g} global iterations, {wall / g * 1e3:.3f} ms "
                        f"each (transitions and ICP included)")
            print(msg, flush=True)

    # the CLI on files: run-pair with every option at once, descriptors
    # from the files
    name = options.OPTION_PAIRS["fpfh"][0]
    c = dataclasses.replace(cfg, norm=1, cfpfh=1, regularizationFPFH=0.001,
                            regularizationNeighbors=0.001)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "bo1")
        (src, tgt), = write_bo1_root(root, [(name, *pools[name][1:], None)],
                                     descriptor_seed=options.DESCRIPTOR_SEED)
        config = os.path.join(root, "config.txt")
        write_config(config, c)

        def cavity(cid):
            return os.path.join(root, "cavities", f"{cid}_cavity6.mol2")
        nd = len(pools[name][1])
        out_dir = os.path.join(tmp, "run_pair")
        t0 = time.perf_counter()
        with _returns(pair_mod, "run_pair") as res:
            _require(cli.main(["run-pair", cavity(tgt), cavity(src), str(nd),
                               config, os.path.join(out_dir, "output.txt"),
                               "1", "--out-dir", out_dir, "--cfpfh-dir",
                               os.path.join(root, "cfpfh"), "--engine",
                               "device", "--device", str(dev), "-q"]) == 0,
                     "run-pair with norm=1, cfpfh=1 and the neighbour term")
        wall = time.perf_counter() - t0
        reg = res[0].registration
        inputs = pair_mod.load_pair_inputs(
            cavity(tgt), cavity(src), c, cfpfh_dir=os.path.join(root, "cfpfh"),
            write_normalized=False)
        same = prepare_pair(inputs.src_n, inputs.tgt_n, inputs.src_props,
                            inputs.tgt_props, c, inputs.src_fpfh,
                            inputs.tgt_fpfh, nd_downsampled=nd, bucket=True,
                            device=dev)
        r = register_device(same, c)
        _require(reg.converged and reg.fpfh_error > 0,
                 f"run-pair {name}: converged {reg.converged}, FPFH term "
                 f"{reg.fpfh_error}")
        _require(abs(reg.error - float(r.error)) <= STREAM_ERR_TOL
                 and reg.outer_steps == int(r.outer_iters)
                 and reg.bound_evals == int(r.evals),
                 f"run-pair {name}: error {reg.error}, outer "
                 f"{reg.outer_steps}, evals {reg.bound_evals} vs "
                 f"register_device on the same prepared pair {_row_of(r)}")
        _require(os.path.exists(os.path.join(out_dir, "output.txt")),
                 "run-pair wrote output.txt")
        print(f"phase 11 run-pair {name} (norm=1, cfpfh=1, "
              f"regularizationFPFH=0.001, regularizationNeighbors=0.001, "
              f"descriptors from the files): command {wall:.3f} s, error "
              f"{reg.error!r} = geom {reg.geom_error!r} + incomp and "
              f"neighbours {reg.incomp_error!r} + FPFH {reg.fpfh_error!r}, "
              f"outer {reg.outer_steps}, evals {reg.bound_evals}; equal to "
              f"register_device on the same prepared pair", flush=True)

    counts = cuda_eval.launch_counts()
    wall = time.perf_counter() - t_phase
    _sums_in_prep(counts, "phase 11", others="the options' own (the c-FPFH "
                  "and neighbour terms' torch inner body and gather path)")
    # (sq_dist3 launches here too: the rescoring check's
    # nn_correspondences above)
    for kname in counts:
        _require(counts[kname] > 0
                 or kname in OFF_PATH + CHECK_ONLY + IN_STEP[1:]
                 + REFINED_AWAY + ("inner_step",),
                 f"{kname} launched in phase 11")
    _refined_away(counts, "phase 11")
    # the inner step alone, after the phase's launches were read: its calls
    # time the step and are not the path
    for option, (two, c) in step_pairs.items():
        per_iter[option].update(_inner_step_cost(two, c, sync))
        print(f"phase 11 {option}: the inner step alone on the "
              f"{per_iter[option]['path']} path (two live rows): "
              f"{per_iter[option]['step_ms']:.3f} ms and "
              f"{per_iter[option]['step_launches']:.1f} kernel launches",
              flush=True)
    print(f"phase 11 wall {wall:.3f} s (the inner-step timings after it: "
          f"{time.perf_counter() - t_phase - wall:.3f} s); per global "
          f"iteration: {json.dumps(per_iter)}; launches during phase 11: "
          f"{json.dumps(counts)}", flush=True)
    return counts


def _ordered_sum_checks(k, cfg, pools, dev, floor):
    """Phase 2's check of the ordered-sum kernel (utils/fp32.py) at the
    main path's and the ICP's shapes on syn07 (icp_seeds rows): the
    rescoring's sums over the points (rows of Nd, what the main path
    launches it for since rotate took the rotated points), the rotated
    points' dot products (rows of 3), the sum over the points of the
    correspondence matrix H (rows of Nd, 9 apart) and the Kabsch's
    sequential 3-term sums, each equal to ordered_sum_plain on the same
    card tensor bit for bit, timed like the bound kernels; the library
    call is torch.sum on the same input (the same sum in its own order),
    timed in turns with the kernel.  The first case's numbers go to the
    kernels line."""
    import numpy as np
    import torch
    from goicp_tpu_torch.utils import fp32
    pair = _prepared("syn07", cfg, pools, dev)
    K = cfg.icp_seeds
    rng = np.random.default_rng(11)
    pts = torch.as_tensor(rng.uniform(-0.8, 0.8, (K, pair.n_data_padded, 3)),
                          dtype=torch.float32, device=dev)
    A = torch.as_tensor(rng.normal(size=(K, 3, 3)), dtype=torch.float32,
                        device=dev)
    cases = (
        ("the rescoring's sums, rows of Nd", pts[..., 0] * pts[..., 1], -1,
         32),
        ("rotated points, dot3", A[:, None, :, :] * pair.data[None, :, None],
         -1, 32),
        ("H, sum over the points", pts[:, :, :, None] * pts[:, :, None, :],
         1, 32),
        ("Kabsch, sequential 3-term", A * A, -1, 1))
    for i, (label, x, dim, lanes) in enumerate(cases):
        x = x.contiguous()

        def kern(x=x, dim=dim, lanes=lanes):
            return fp32.ordered_sum(x, dim, lanes)

        def plain(x=x, dim=dim, lanes=lanes):
            return fp32.ordered_sum_plain(x, dim, lanes)

        def library(x=x, dim=dim):
            return torch.sum(x, dim=dim)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        _require(_same_bits([got], [want]),
                 f"ordered_sum == plain bit for bit ({label})")
        err = _max_err([got], [want])
        k["errs"].append(err)
        if i == 0:
            ks, ls = _alternated(kern, library)
            ms, lms = statistics.median(ks), statistics.median(ls)
            how = f"medians of {len(ks)} alternated"
        else:
            (ms, lms), how = _in_turns(kern, library), "in turns"
        pms, dms = _median_ms(plain), _device_ms(kern)
        n = x.shape[dim]
        bms, bby = _bound(got.numel(), n, [x, got])
        if i == 0:
            k.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                     graph_ms=dms, library_ms=lms)
        print(f"ordered_sum {label}: x {tuple(x.shape)} over dim {dim}, "
              f"lanes {lanes}: max_abs_err={err:.3g} (bit for bit) kernel "
              f"{ms:.4f} ms (from a graph {dms:.4f} ms) plain {pms:.4f} ms "
              f"torch.sum {lms:.4f} ms ({how}) bound {bms:.6f} ms "
              f"({bby}) {floor}", flush=True)


def _product_checks(kernels, cfg, pools, dev, floor):
    """Phase 2's check of the fixed-order product kernels (utils/fp32.py,
    csrc/fp32_products.cu) at the ICP's shapes on syn07 (an event of
    icp_seeds rows): sq_dist3 on the rotated points against the model,
    det3 and dot_fma (R = V (d U)^T) on the Kabsch's 3x3 matrices and
    cross3 on a column of one against a row of another (strided operands,
    as the Jacobi's completion passes them), each equal to its plain
    version (the elementwise torch form) on the same card tensors bit for
    bit, timed like the bound kernels.  The library call computes the same
    function in its own order: torch.linalg.det, torch.linalg.cross,
    torch.matmul; none for the squared distance matrix (torch.cdist takes
    the square root)."""
    import numpy as np
    import torch
    from goicp_tpu_torch.utils import fp32
    pair = _prepared("syn07", cfg, pools, dev)
    K = cfg.icp_seeds
    rng = np.random.default_rng(12)
    pts = torch.as_tensor(rng.uniform(-0.8, 0.8, (K, pair.n_data_padded, 3)),
                          dtype=torch.float32, device=dev)
    V, U = (torch.as_tensor(rng.normal(size=(K, 3, 3)), dtype=torch.float32,
                            device=dev) for _ in range(2))
    Vb, Ub = V[..., :, None, :], U[..., None, :, :]
    # name: (kernel, plain, library, args, function evaluations, operations
    # per evaluation)
    cases = {
        "sq_dist3": (fp32.sq_dist3, fp32.sq_dist3_plain, None,
                     (pts, pair.model), pts.shape[0] * pts.shape[1]
                     * pair.model.shape[0], 8),
        "det3": (fp32.det3, fp32.det3_plain, torch.linalg.det, (V,), K, 14),
        "cross3": (fp32.cross3, fp32.cross3_plain, torch.linalg.cross,
                   (V[:, :, 0], U[:, 1]), K, 9),
        "dot_fma": (fp32.dot_fma, fp32.dot_fma_plain,
                    lambda a, b: torch.matmul(V, U.transpose(-1, -2)),
                    (Vb, Ub), K * 9, 5),
    }
    for name, (kern_fn, plain_fn, lib_fn, args, n_eval, ops) in cases.items():
        k = kernels[name]

        def kern(fn=kern_fn, args=args):
            return fn(*args)

        def plain(fn=plain_fn, args=args):
            return fn(*args)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        _require(_same_bits([got], [want]),
                 f"{name} == plain bit for bit")
        err = _max_err([got], [want])
        k["errs"].append(err)
        pms, dms = _median_ms(plain), _device_ms(kern)
        extra = ""
        if lib_fn is None:
            ms, lms = _median_ms(kern), None
        elif name == "cross3":
            ks, ls = _alternated(kern, lambda fn=lib_fn, args=args:
                                 fn(*args))
            ms, lms = statistics.median(ks), statistics.median(ls)
            extra = (f"; alternated x{len(ks)}: cross3 median {ms:.4f} ms "
                     f"[{min(ks):.4f}-{max(ks):.4f}], linalg.cross median "
                     f"{lms:.4f} ms [{min(ls):.4f}-{max(ls):.4f}]")
        else:
            ms, lms = _in_turns(kern, lambda fn=lib_fn, args=args: fn(*args))
        bms, bby = _bound(n_eval, ops, [*args, got])
        k.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                 graph_ms=dms, library_ms=lms)
        shapes = " x ".join(str(tuple(a.shape)) for a in args)
        how = "alternated" if name == "cross3" else "in turns"
        lib = "none" if lms is None else f"{lms:.4f} ms ({how})"
        print(f"{name}: {shapes}: max_abs_err={err:.3g} (bit for bit) "
              f"kernel {ms:.4f} ms (from a graph {dms:.4f} ms) plain "
              f"{pms:.4f} ms library {lib}{extra} bound {bms:.6f} ms "
              f"({bby}) {floor}", flush=True)


# operations a function needs: rotate 5 a coordinate (3 products, 2 sums)
# and 1 more with t; norm3 6 a vector (a product, two FMAs of 2, a square
# root); sincos32 40 float64 operations an angle (the reduction 6, z 1, two
# Horner chains of 14, sin r 3, cos r 2), its sine alone 24; rodrigues a
# vector norm3's 6, u 3 divisions, 1 - cos 1 and 6 an entry of R (ct e,
# st K, their sum, u_i u_j, its product with 1 - cos, the sum) in float32,
# and sincos32's 40 in float64; rot_uncertainty a lane 5 in float32
# (sqrt3 w, / 2, the clamp, / 2, 2 s) and the sine's 24 in float64, and 1
# an output (the product with the point's norm)
ROTATE_OPS, NORM3_OPS, SINCOS_OPS, SINE_OPS = 15, 6, 40, 24
RODRIGUES_OPS = NORM3_OPS + 3 + 1 + 9 * 6
ROT_UNC_LANE_OPS = 5


def _ops_s(f32=0, f64=0):
    """Seconds the card needs for f32 float32 and f64 float64 operations
    at its peak rates (outside the tensor cores)."""
    return f32 / PEAK_OPS + f64 / PEAK_OPS_F64


def _fused_checks(kernels, cfg, pools, dev, floor):
    """Phase 2's check of the fixed-order functions that are one launch
    each (utils/fp32.py, geom/rotation.py's rodrigues, bounds/evaluate.py's
    rot_uncertainty): rotate at an outer transition's shape (8 R from 8
    seeded rotation centres through rodrigues, times syn07's data) and at
    the rescoring's (4 R, with t), norm3 at the centres' shape (8, 3) and
    the preparation's (syn07's data), sincos32 at (8,) (the centres'
    angles), rodrigues of the 8 centres (the host engine's lanes) and
    rot_uncertainty of 8 widths of the BnB's levels (2 pi / 2^k, k = 1..8)
    times syn07's point norms, each equal to its plain version
    (rotate_plain, norm3_plain, sincos32_plain, rodrigues_plain,
    rot_uncertainty_plain: elementwise torch ops, launching no kernel of
    ours) on the same card tensors bit for bit, timed like the bound
    kernels; the library call (torch.matmul,
    torch.baddbmm, torch.linalg.vector_norm) is timed in turns with the
    kernel, norm3 and vector_norm alternated (medians of 10); none
    computes sin and cos at once, so sincos32 has none and is alternated
    with one torch.sin (printed, and kept as the entry's `sin_ms`), torch
    .sin + torch.cos printed beside it; rodrigues and rot_uncertainty have
    none.  rodrigues and rot_uncertainty are one kernel launch and no
    memset a call (torch.profiler).  The first case of each goes to the
    kernels line.  Then, untimed, each bit for bit on wide inputs, and
    cross3 in six layouts."""
    import numpy as np
    import torch
    from goicp_tpu_torch.bounds.evaluate import (rot_uncertainty,
                                                 rot_uncertainty_plain)
    from goicp_tpu_torch.geom.rotation import rodrigues, rodrigues_plain
    from goicp_tpu_torch.utils import fp32
    pair = _prepared("syn07", cfg, pools, dev)
    rng = np.random.default_rng(14)
    centers = torch.as_tensor(rng.uniform(-1.8, 1.8, (8, 3)),
                              dtype=torch.float32, device=dev)
    R8 = rodrigues(centers)
    R4 = R8[:4].contiguous()
    t4 = torch.as_tensor(rng.uniform(-0.05, 0.05, (4, 3)),
                         dtype=torch.float32, device=dev)
    data = pair.data
    n = data.shape[0]
    angles = fp32.norm3(centers)
    data_b = data.expand(4, n, 3)
    widths = torch.tensor([2 * np.pi / 2 ** k for k in range(1, 9)],
                          dtype=torch.float32, device=dev)
    nd = pair.norm_data
    L, Nd = widths.shape[0], nd.shape[0]
    # name, label, kernel, plain, library (None: none), seconds of the
    # operations at the card's peak, inputs
    cases = (
        ("rotate", "8 R x syn07's data (an outer transition)",
         lambda: fp32.rotate(R8, data), lambda: fp32.rotate_plain(R8, data),
         lambda: torch.matmul(data, R8.transpose(-1, -2)),
         _ops_s(8 * n * ROTATE_OPS), (R8, data)),
        ("rotate", "4 R x syn07's data + t (a rescoring)",
         lambda: fp32.rotate(R4, data, t4),
         lambda: fp32.rotate_plain(R4, data, t4),
         lambda: torch.baddbmm(t4[:, None, :], data_b,
                               R4.transpose(-1, -2)),
         _ops_s(4 * n * (ROTATE_OPS + 3)), (R4, data, t4)),
        ("norm3", "the rotation centres (8, 3)",
         lambda: fp32.norm3(centers), lambda: fp32.norm3_plain(centers),
         lambda: torch.linalg.vector_norm(centers, dim=-1),
         _ops_s(8 * NORM3_OPS), (centers,)),
        ("norm3", "syn07's data (the preparation)",
         lambda: fp32.norm3(data), lambda: fp32.norm3_plain(data),
         lambda: torch.linalg.vector_norm(data, dim=-1),
         _ops_s(n * NORM3_OPS), (data,)),
        ("sincos32", "the centres' angles (8,)",
         lambda: fp32.sincos32(angles), lambda: fp32.sincos32_plain(angles),
         None, _ops_s(f64=8 * SINCOS_OPS), (angles,)),
        ("rodrigues_kernel", "the rotation centres (8, 3) (the host "
         "engine's lanes)", lambda: rodrigues(centers),
         lambda: rodrigues_plain(centers), None,
         _ops_s(8 * RODRIGUES_OPS, 8 * SINCOS_OPS), (centers,)),
        ("rot_uncertainty_kernel",
         f"8 widths x syn07's {Nd} point norms",
         lambda: rot_uncertainty(widths, nd),
         lambda: rot_uncertainty_plain(widths, nd), None,
         _ops_s(L * ROT_UNC_LANE_OPS + L * Nd, L * SINE_OPS),
         (widths, nd)),
    )
    seen = set()
    for name, label, kern, plain, library, t_ops, ins in cases:
        k = kernels[name]
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        _require(_same_bits(got, want), f"{name} == plain bit for bit "
                 f"({label})")
        err = _max_err(got, want)
        k["errs"].append(err)
        pms, dms = _median_ms(plain), _device_ms(kern)
        extra = ""
        if name == "sincos32":
            ks, ls = _alternated(kern, lambda: torch.sin(angles))
            ms, lms = statistics.median(ks), None
            k["sin_ms"] = statistics.median(ls)
            sin_cos = _median_ms(lambda: (torch.sin(angles),
                                          torch.cos(angles)))
            extra = (f"; alternated x{len(ks)}: sincos32 median {ms:.4f} ms "
                     f"[{min(ks):.4f}-{max(ks):.4f}], torch.sin median "
                     f"{k['sin_ms']:.4f} ms [{min(ls):.4f}-{max(ls):.4f}]; "
                     f"torch.sin + torch.cos {sin_cos:.4f} ms")
        elif library is None:
            ms, lms = _median_ms(kern), None
            launches, memsets = _launches_memsets(kern)
            _require(launches == 1 and memsets == 0,
                     f"{name} one kernel launch and no memset a call: "
                     f"{launches}, {memsets}")
            extra = (f"; {launches:g} kernel launch and {memsets:g} memsets "
                     f"a call (torch.profiler)")
        elif name == "norm3":
            ks, ls = _alternated(kern, library)
            ms, lms = statistics.median(ks), statistics.median(ls)
            extra = (f"; alternated x{len(ks)}: norm3 median {ms:.4f} ms "
                     f"[{min(ks):.4f}-{max(ks):.4f}], vector_norm median "
                     f"{lms:.4f} ms [{min(ls):.4f}-{max(ls):.4f}]")
        else:
            ms, lms = _in_turns(kern, library)
        t_bytes = _nbytes(*ins, *got) / PEAK_BYTES
        bms = max(t_ops, t_bytes) * 1e3
        bby = "operations" if t_ops >= t_bytes else "bytes"
        if name not in seen:
            seen.add(name)
            k.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                     graph_ms=dms, library_ms=lms)
        how = "alternated" if name == "norm3" else "in turns"
        lib = "none" if lms is None else f"{lms:.4f} ms ({how})"
        print(f"{name} {label}: max_abs_err={err:.3g} (bit for bit) kernel "
              f"{ms:.4f} ms (from a graph {dms:.4f} ms) plain {pms:.4f} ms "
              f"library {lib}{extra} bound {bms:.6f} ms ({bby}) {floor}",
              flush=True)
    # wide inputs, untimed: 2^16 angles in [-8, 8], 2^16 vectors over six
    # decades; rotation vectors at the edges (zero, on the axes, |v| = pi
    # and next to it, the cube's corner sqrt(3) pi) and 2^12 in the cube
    # [-pi, pi]^3; the BnB's widths 2 pi / 2^k (k = 0..12), 0 and widths
    # where the clamp binds, times syn07's norms (its padding's zeros
    # among them)
    ang = torch.as_tensor(rng.uniform(-8.0, 8.0, 2**16), dtype=torch.float32,
                          device=dev)
    vec = torch.as_tensor(rng.normal(size=(2**16, 3))
                          * 10.0 ** rng.uniform(-3, 3, (2**16, 1)),
                          dtype=torch.float32, device=dev)
    _require(_same_bits(fp32.sincos32(ang), fp32.sincos32_plain(ang))
             and _same_bits([fp32.norm3(vec)], [fp32.norm3_plain(vec)]),
             "sincos32 and norm3 == plain bit for bit on 2^16 inputs")
    pi = np.pi
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    unit = rng.normal(size=(16, 3))
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    rv = np.concatenate([
        np.zeros((1, 3)), axes * pi / 2, axes * pi,
        axes * pi * (1 - 2.0 ** -20), axes * pi * (1 + 2.0 ** -20),
        unit * pi, unit * np.float32(pi), [[pi, pi, pi], [-pi, pi, -pi]],
        rng.uniform(-pi, pi, (2**12, 3))])
    rv = torch.as_tensor(rv, dtype=torch.float32, device=dev)
    wide_w = torch.as_tensor(np.concatenate([
        [2 * pi / 2 ** k for k in range(13)], [0.0],
        rng.uniform(3.5, 8.0, 8)]), dtype=torch.float32, device=dev)
    _require(_same_bits([rodrigues(rv)], [rodrigues_plain(rv)])
             and _same_bits([rodrigues(rv[5])], [rodrigues_plain(rv[5])])
             and _same_bits([rot_uncertainty(wide_w, nd)],
                            [rot_uncertainty_plain(wide_w, nd)]),
             "rodrigues and rot_uncertainty == plain bit for bit on wide "
             "inputs")
    # cross3 in six layouts: contiguous, strided, each side broadcast, two
    # vectors, and two leading dims
    a = torch.as_tensor(rng.normal(size=(64, 3, 3)), dtype=torch.float32,
                        device=dev)
    b = torch.as_tensor(rng.normal(size=(64, 3, 3)), dtype=torch.float32,
                        device=dev)
    layouts = ((a[:, 0], b[:, 1]), (a[:, :, 0], b[:, 1]), (a[:, 0], b[0, 1]),
               (a[:1, 0], b[:, :, 2]), (a[0, 0], b[0, :, 1]),
               (a[:4, :, None, :], b[:4, None, :, :]))
    for x, y in layouts:
        _require(_same_bits([fp32.cross3(x, y)], [fp32.cross3_plain(x, y)]),
                 f"cross3 == plain bit for bit at {tuple(x.shape)} "
                 f"{x.stride()} x {tuple(y.shape)} {y.stride()}")
    print(f"sincos32 on 2^16 angles in [-8, 8], norm3 on 2^16 vectors over "
          f"six decades, rodrigues on {rv.shape[0]} rotation vectors (the "
          f"edges and the cube), rot_uncertainty on {wide_w.shape[0]} widths "
          f"x {Nd} norms, cross3 in {len(layouts)} layouts: bit for bit",
          flush=True)


def _icp_bound(res, nd, m, mode, tensors):
    """(bound_ms, bound_by) of an ICP event that ran res.iters iterations
    per row: ICP_OPS per iteration (the trimmed modes' stable ranks ~2
    Nd^2 more) over PEAK_OPS against the inputs and outputs once over
    PEAK_BYTES."""
    from goicp_tpu_torch.icp.icp import MODE_DYN_TRIM, MODE_TRIM
    per_iter = ICP_OPS(nd, m) + (2 * nd * nd if mode in (MODE_TRIM,
                                                          MODE_DYN_TRIM)
                                 else 0)
    t_ops = int(res.iters.sum()) * per_iter / PEAK_OPS
    t_bytes = _nbytes(*tensors, *res) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# the inner step's modes in phase 2: (label, pair set, cfg changes, fused,
# rotation uncertainty, K static)
STEP_MODES = (
    ("syn07 fused, corner reuse", "syn07", {}, True, True, False),
    ("syn07 fused, 27 corners", "syn07", dict(chem_reuse=0), True, True,
     False),
    ("syn07 fused, no chem term", "syn07", dict(regularization=0.0), True,
     True, False),
    ("syn07 fused, sorted_merge", "syn07", dict(sorted_merge=1), True, True,
     False),
    ("syn07 fused, norm 1", "syn07", dict(norm=1), True, True, False),
    ("syn07 plain + unc", "syn07", {}, False, True, False),
    ("syn07 plain", "syn07", {}, False, False, False),
    ("trm00 fused, K = counts[1]", "trm00", {}, True, True, False),
    ("trm00 fused, K static", "trm00", {}, True, True, True),
    ("trm00 plain + unc, K static", "trm00", {}, False, True, True),
    ("syn07 fused, P 80, C 5000", "syn07",
     dict(trans_pop=80, trans_capacity=5000), True, True, False),
    ("syn00 + syn01 lanes interleaved", ("syn00", "syn01"), {}, True, True,
     False),
    ("trm00 + trm01 lanes interleaved", ("trm00", "trm01"), {}, True, True,
     False),
)
STEP_WARM = 3          # plain steps before the compared ones
STEP_INC = 1e4         # the lanes' first incumbent: above every ub
STEP_COMPARED = 3      # kernel vs plain, each on the state both reached


def _step_inputs(names, c, pools, dev, rng, static=False, lanes=8):
    """(pair or LaneTables, L lanes' points, rotation widths, active mask,
    groups): one prepared pair (`lanes` lanes, 8: register_device's shape;
    static: prepared without count-dynamic, so its K is the inlier count)
    or two pairs in one bucket with 16 lanes interleaved between them (the
    streams' shape, two window rows)."""
    import numpy as np
    import torch
    from goicp_tpu_torch.bench.measure import (_bucket_and_prepare,
                                               _normalized_synthetic)
    from goicp_tpu_torch.bounds.evaluate import lane_tables
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    from goicp_tpu_torch.pipeline.prepare import prepare_pair
    if isinstance(names, str):
        pair = prepare_pair(*_normalized_synthetic(pools[names]), c,
                            bucket=True, device=dev) if static \
            else _prepared(names, c, pools, dev)
        pairs, lane_pair, L = [pair], [0] * lanes, lanes
    else:
        pairs = _bucket_and_prepare([_normalized_synthetic(pools[n])
                                     for n in names], c, device=dev)
        lane_pair = [0, 1, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0]
        L = 16
    rots = np.stack([rodrigues_np(v) for v in rng.uniform(-2.5, 2.5,
                                                          (L, 3))])
    pts = torch.stack([
        torch.as_tensor(rots[l], dtype=torch.float32, device=dev)
        @ pairs[w].data.T for l, w in enumerate(lane_pair)]).transpose(1, 2)
    pts = torch.as_tensor(np.asarray(pts.cpu()), device=dev).contiguous()
    widths = torch.as_tensor(rng.uniform(0.05, 0.6, L), dtype=torch.float32,
                             device=dev)
    active = torch.as_tensor(rng.uniform(size=L) < 0.8, device=dev)
    active[0] = True
    if len(pairs) == 1:
        return pairs[0], pairs, lane_pair, pts, widths, active
    tables = lane_tables(stack_pairs(pairs), c, torch.as_tensor(
        lane_pair, dtype=torch.int32, device=dev))
    return tables, pairs, lane_pair, pts, widths, active


def _step_root(pairs, lane_pair, c, pts, active, inc):
    """inner_bnb's initial lanes (inner.initial_lanes) with the incumbent
    `inc`, each lane's root corner payload from its own pair."""
    import torch
    from goicp_tpu_torch.search import inner
    s = inner.initial_lanes(pairs[0], c, pts, active,
                            torch.tensor(inc, device=pts.device))
    for w, pair in enumerate(pairs[1:], 1):
        sel = torch.tensor([l for l, p in enumerate(lane_pair) if p == w],
                           device=pts.device)
        if "cvals" in s:
            s["cvals"][sel, 0] = inner.root_corner_values(pair, c, pts[sel])
    return s


def _step_same(got, want):
    """Every field of two step results equal: float32 bit for bit, NaN to
    NaN; -> the fields that differ."""
    import torch
    bad = []
    for part in (0, 1):
        for k, w in want[part].items():
            g = got[part][k]
            if g.dtype == torch.float32:
                ok = g.shape == w.shape and bool(torch.all(
                    (g.view(torch.int32) == w.view(torch.int32))
                    | (torch.isnan(g) & torch.isnan(w))))
            else:
                ok = torch.equal(g.to(w.dtype), w)
            if not ok:
                bad.append(f"{k}: {_first_diff(g.cpu(), w.cpu())}")
    for f in ("evals", "geom_surv", "n_active"):
        if not torch.equal(getattr(got[2], f), getattr(want[2], f).to(
                getattr(got[2], f).dtype)):
            bad.append(f)
    if got[2].corners_per_lane != want[2].corners_per_lane:
        bad.append("corners_per_lane")
    return bad


def _step_checks(k, cfg, cfg_t, pools, dev, floor):
    """Phase 2's check of the inner step kernel (csrc/inner.cu,
    search/inner.py::inner_step): one whole inner-BnB iteration for a lane
    batch, held to inner_step_plain (the torch body; on the card its bounds
    are K1-K4's launches) on the same card tensors, every output field,
    counter and the active-lane count bit for bit, in each mode of
    STEP_MODES: from the root state (about a fifth of the lanes done from
    the start), STEP_WARM plain steps, then STEP_COMPARED steps compared,
    the two-pair cases as two window rows of 8 lanes with per-row
    counters, the second row not live in the last step.  Then built NaN
    and INF lbs (a frontier entry NaN, another INF, a popped parent's lb
    NaN, a stored corner NaN, so that a child's ub and lb are NaN and a
    lane adopts a NaN) through both merge orders.  Timed at the streams'
    shape (syn00 + syn01, 16 lanes) and at register_device's (syn07, 8
    lanes); the kernels line takes the former.  The bound: K3's and K4's
    operations on the children and corners this step evaluates (its
    evals and corners), over the fp32 peak, against the state, points
    and tables read once and the state written once."""
    import numpy as np
    import torch
    from goicp_tpu_torch.bounds.evaluate import LaneTables, rot_uncertainty
    from goicp_tpu_torch.search import inner
    rng = np.random.default_rng(2027)
    timed = {}
    for label, names, over, fused, unc, static in STEP_MODES:
        c = dataclasses.replace(cfg_t if "trm" in label else cfg, **over)
        pair, pairs, lane_pair, pts, widths, active = _step_inputs(
            names, c, pools, dev, rng, static)
        mrd = torch.cat([
            rot_uncertainty(widths[l:l + 1], pairs[w].norm_data)
            for l, w in enumerate(lane_pair)]) if (fused or unc) else None
        s = _step_root(pairs, lane_pair, c, pts, active, STEP_INC)
        groups = len(pairs)
        cnt = {key: torch.zeros((groups,), dtype=torch.int32, device=dev)
               for key in inner._COUNTERS}
        for _ in range(STEP_WARM):
            s, cnt, _ = inner.inner_step_plain(pair, c, s, pts, mrd, fused,
                                               groups=groups, counters=cnt)
        for i in range(STEP_COMPARED):
            live = None
            if groups == 2 and i == STEP_COMPARED - 1:
                live = torch.tensor([True, False], device=dev)
            args = (pair, c, s, pts, mrd, fused)
            kw = dict(live=live, groups=groups, counters=cnt)
            _require(_merge_ordered(s["lbs"], c),
                     f"{label}: the rest in the merge's order")
            got = inner.inner_step(*args, **kw)
            want = inner.inner_step_plain(*args, **kw)
            torch.cuda.synchronize()
            bad = _step_same(got, want)
            _require(not bad, f"inner_step == plain bit for bit ({label}, "
                     f"step {i}): {bad}")
            s, cnt = got[0], got[1]
        k["errs"].append(0.0)
        print(f"inner_step {label}: L={pts.shape[0]} Nd={pts.shape[1]} "
              f"C={c.trans_capacity} P={c.trans_pop} evals "
              f"{int(cnt['evals'].sum())} after {STEP_WARM + STEP_COMPARED} "
              f"steps, {int(got[2].n_active)} lanes active: every field, "
              f"counter and the active count bit for bit", flush=True)
        if label.startswith(("syn00", "syn07 fused, corner")):
            timed[label] = (pair, c, s, pts, mrd, fused, groups, cnt)

    # built NaN / INF lbs, through both merge orders
    for merge in (0, 1):
        c = dataclasses.replace(cfg, sorted_merge=merge)
        pair, pairs, lane_pair, pts, widths, _ = _step_inputs(
            "syn07", c, pools, dev, rng)
        active = torch.ones(8, dtype=torch.bool, device=dev)
        mrd = rot_uncertainty(widths, pair.norm_data)
        s = _step_root(pairs, lane_pair, c, pts, active, STEP_INC)
        for _ in range(2):
            s, _, _ = inner.inner_step_plain(pair, c, s, pts, mrd, True)
        lbs, cv = s["lbs"].clone(), s["cvals"].clone()
        fin = torch.isfinite(lbs).sum(dim=1).tolist()
        _require(min(fin) > c.trans_pop + 2, "NaN case: frontiers filled")
        # NaN after +inf under sorted_merge 0, among them under 1: the
        # frontier past the pop stays in the merge's order
        if merge:
            lbs[0, fin[0] - 1] = float("nan")
            lbs[1, fin[1]] = float("nan")
        else:
            lbs[0, fin[0] - 1:] = float("nan")
            lbs[1, -1] = float("nan")
        lbs[0, fin[0] - 2] = float("inf")
        lbs[1, fin[1] - 1] = float("inf")
        _require(_merge_ordered(lbs, c), "NaN case: the rest in the "
                 "merge's order")
        lbs[3, 1] = float("nan")
        cv[4, 0, 3] = float("nan")
        s = dict(s, lbs=lbs, cvals=cv)
        got = inner.inner_step(pair, c, s, pts, mrd, True)
        want = inner.inner_step_plain(pair, c, s, pts, mrd, True)
        torch.cuda.synchronize()
        bad = _step_same(got, want)
        _require(not bad and bool(torch.isnan(got[0]["opt_err"][4])),
                 f"inner_step == plain with NaN/INF lbs (sorted_merge="
                 f"{merge}): {bad}")
        k["errs"].append(0.0)
        print(f"inner_step NaN/INF lbs, sorted_merge={merge}: every field "
              f"bit for bit (lane 4 adopted a NaN child)", flush=True)

    for label, (pair, c, s, pts, mrd, fused, groups, cnt) in timed.items():
        # the kernel as the loops call it: its outputs from a run's buffers
        def kern(a=(pair, c, s, pts, mrd, fused), kw=dict(
                groups=groups, counters=cnt, bufs=inner.StepBuffers())):
            return inner.inner_step(*a, **kw)

        def plain(a=(pair, c, s, pts, mrd, fused), kw=dict(
                groups=groups, counters=cnt)):
            return inner.inner_step_plain(*a, **kw)
        out = kern()
        ms, pms, dms = (_median_ms(kern), _median_ms(plain),
                        _device_ms(kern))
        if isinstance(pair, LaneTables):
            real = (pair.data_mask > 0).sum(dim=1)[pair.lane_pair.long()]
            tabs = [pair.weights, pair.cell_coords, pair.nearest_cell,
                    pair.consts, pair.cell_compat, pair.prop_onehot,
                    pair.data_mask]
        else:
            real = torch.full((pts.shape[0],), _real_points(pair),
                              device=dev)
            tabs = [pair.weights, pair.grid.cell_coords,
                    pair.grid.nearest_cell, pair.grid.consts,
                    pair.cell_compat, pair.prop_onehot, pair.data_mask]
        # per lane: its evaluated children and (not done) its corners, over
        # its pair's real points
        ops = int(torch.sum(real * (
            out[2].evals * GEOM_OPS[(c.norm, fused)]
            + (~out[0]["done"]).to(torch.int32) * out[2].corners_per_lane
            * CHEM_OPS)))
        state = [s[f] for f in s] + [pts, mrd]
        t_ops = ops / PEAK_OPS
        t_bytes = (_nbytes(*state, *tabs) + _nbytes(*out[0].values())) \
            / PEAK_BYTES
        bms, bby = max(t_ops, t_bytes) * 1e3, \
            "operations" if t_ops >= t_bytes else "bytes"
        if label.startswith("syn00"):
            k.update(ms=ms, plain_ms=pms, graph_ms=dms, bound_ms=bms,
                     bound_by=bby)
        print(f"inner_step timed, {label}: L={pts.shape[0]} kernel "
              f"{ms:.4f} ms (from a graph {dms:.4f} ms) plain {pms:.4f} ms "
              f"bound {bms:.6f} ms ({bby}; {ops} operations) {floor}",
              flush=True)


def _merge_ordered(lbs, c):
    """Each row's frontier past the pop (entries trans_pop..C-1) in the
    inner merge's order, which csrc/inner.cu's merge requires and every
    merge leaves: ascending, NaN ranked as +inf (sorted_merge 1) or after
    it (sorted_merge 0)."""
    import torch
    rest = lbs[..., c.trans_pop:]
    nan = torch.isnan(rest)
    key = torch.where(nan, float("inf"), rest)
    return bool((key[..., 1:] >= key[..., :-1]).all()) and (
        bool(c.sorted_merge) or bool((nan[..., :-1] <= nan[..., 1:]).all()))


# the run's cases in phase 2 beside STEP_MODES': a lane batch larger than
# the grid the card holds at once (register_device's configuration, syn07,
# RUN_MANY_LANES lanes): clusters take lanes one after another, or the
# lanes stride over them (mode stream)
RUN_MANY_LANES = 256
RUN_STREAM_STEPS = 40  # mode stream's cap in phase 2


def _run_same(got, want):
    """Every lane field and counter of two inner runs and their iteration
    counts equal: float32 bit for bit, NaN to NaN; -> what differs."""
    import torch
    bad = []
    for part in ("lanes", "counters"):
        g_d, w_d = getattr(got, part), getattr(want, part)
        for k, w in w_d.items():
            g = g_d[k]
            if g.dtype == torch.float32:
                ok = g.shape == w.shape and bool(torch.all(
                    (g.view(torch.int32) == w.view(torch.int32))
                    | (torch.isnan(g) & torch.isnan(w))))
            else:
                ok = g.shape == w.shape and torch.equal(g.to(w.dtype), w)
            if not ok:
                bad.append(f"{part} {k}: {_first_diff(g.cpu(), w.cpu())}")
    if int(got.iters) != int(want.iters):
        bad.append(f"iters {int(got.iters)} vs {int(want.iters)}")
    return bad


def _run_bound(pair, out, c, fused, state, tabs):
    """(bound_ms, bound_by, operations) of one run: per evaluated child
    GEOM_OPS and per expanded parent its share of the lattice (corners /
    trans_pop corners) CHEM_OPS, each over its pair's real points (the
    fewest of a window's pairs), over the fp32 peak; against the lanes'
    state, points and tables read once and the state written once."""
    import torch
    from goicp_tpu_torch.bounds.evaluate import LaneTables
    from goicp_tpu_torch.search import inner
    real = int((pair.data_mask > 0).sum(dim=-1).min()) \
        if isinstance(pair, LaneTables) else _real_points(pair)
    evals = int(out.counters["evals"].sum())
    per_parent = ((19 if inner._chem_reuse_active(c) else 27)
                  if inner._chem_active(c) else 0)
    ops = real * (evals * GEOM_OPS[(c.norm, fused)]
                  + evals // 8 * per_parent * CHEM_OPS)
    t_ops = ops / PEAK_OPS
    t_bytes = (_nbytes(*state, *tabs) + _nbytes(*out.lanes.values())) \
        / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops)


def _run_checks(k, kernels, cfg, cfg_t, pools, dev, floor):
    """Phase 2's check of the inner run (csrc/inner.cu goicp_inner_run,
    search/inner.py::inner_run): the iterations of a search in one launch,
    held to inner_run_plain (the torch loops it replaces, each step the
    torch body) on the same card tensors, every lane field, counter and
    the iteration count bit for bit, in each case of STEP_MODES from the
    root state (about a fifth of the lanes done from the start) in the
    three stop modes: "search" (inner_bnb's whole search), "groups" (two
    groups, each until its own search is complete), "stream" (two groups:
    both live until one completes or RUN_STREAM_STEPS iterations; only
    the first live; `once`: one iteration), each printing the lanes whose
    state stayed in a cluster's shared memory and those that strided.
    Then syn07 at RUN_MANY_LANES lanes, more than the card holds clusters
    at once: in modes search and groups a cluster takes one lane after
    another, in mode stream the lanes stride.  Timed in mode search at
    register_device's shape (syn07, 8 lanes; the kernels line takes it;
    once more without the chem term) and in mode stream at the streams'
    (syn00 + syn01, 16 lanes): single calls with the run's buffers as the
    engines make them (ms; one kernel launch and no memset a call,
    counted by torch.profiler) and with a block built and outputs
    allocated a call, from a CUDA graph (graph_ms) beside the same
    iterations as inner_step launches replayed from a graph, and the
    plain loop (a host read an iteration)."""
    import numpy as np
    import torch
    from goicp_tpu_torch.bounds.evaluate import LaneTables, rot_uncertainty
    from goicp_tpu_torch.search import inner
    from goicp_tpu_torch.search.args import TransitionBuffers
    rng = np.random.default_rng(2028)
    timed = {}
    cases = [m + (8,) for m in STEP_MODES] + [
        (f"syn07 fused, {RUN_MANY_LANES} lanes", "syn07", {}, True, True,
         False, RUN_MANY_LANES)]
    for label, names, over, fused, unc, static, n_lanes in cases:
        c = dataclasses.replace(cfg_t if "trm" in label else cfg, **over)
        pair, pairs, lane_pair, pts, widths, active = _step_inputs(
            names, c, pools, dev, rng, static, lanes=n_lanes)
        mrd = torch.cat([
            rot_uncertainty(widths[l:l + 1], pairs[w].norm_data)
            for l, w in enumerate(lane_pair)]) if (fused or unc) else None
        s = _step_root(pairs, lane_pair, c, pts, active, STEP_INC)
        _require(_merge_ordered(s["lbs"], c),
                 f"{label}: the rest in the merge's order")
        L = pts.shape[0]
        t = torch.tensor
        runs = [("search", {}), ("groups", dict(groups=2))]
        if n_lanes > 8:
            # more lanes than clusters: the stream strides over them
            runs.append(("stream", dict(groups=2, steps=RUN_STREAM_STEPS)))
        else:
            runs += [
                ("stream", dict(groups=2, steps=RUN_STREAM_STEPS)),
                ("stream, the first live", dict(
                    groups=2, steps=RUN_STREAM_STEPS,
                    live=t([True, False], device=dev),
                    watch=t([True, True], device=dev))),
                ("stream, once", dict(groups=2, steps=RUN_STREAM_STEPS,
                                      once=t(True, device=dev)))]
        said = []
        for mode_label, kw in runs:
            mode = mode_label.split(",")[0]
            if "groups" in kw:
                kw = dict(kw, counters={
                    key: t([3, 5], dtype=torch.int32, device=dev)
                    for key in inner._COUNTERS})
            args = (pair, c, s, pts, mrd, fused, mode)
            got = inner.inner_run(*args, **kw)
            want = inner.inner_run_plain(*args, **kw)
            torch.cuda.synchronize()
            bad = _run_same(got, want)
            _require(not bad, f"inner_run == plain bit for bit ({label}, "
                     f"{mode_label}): {bad}")
            said.append(f"{mode_label} {int(got.iters)} iterations, "
                        f"{int(got.resident)} lanes resident, "
                        f"{L - int(got.resident)} strided")
            if n_lanes > 8:
                _require(L > int(got.clusters),
                         f"{label}: {L} lanes stride over the "
                         f"{int(got.clusters)} clusters the card holds")
                said.append(f"on {int(got.clusters)} clusters")
            if (mode_label in ("search", "stream") and label.startswith(
                    ("syn00", "syn07 fused, corner"))) or (
                    mode_label == "search"
                    and label == "syn07 fused, no chem term"):
                timed[(label, mode)] = (pair, c, s, pts, mrd, fused, kw,
                                        got)
        k["errs"].append(0.0)
        print(f"inner_run {label}: L={L} Nd={pts.shape[1]} "
              f"C={c.trans_capacity} P={c.trans_pop}: "
              + ", ".join(said) + "; every field, counter and the "
              "iteration count bit for bit", flush=True)

    k3k4 = sum(kernels[n].get("graph_ms", 0.0) for n in (
        "geometric_bounds_kernel_lanes", "chem_incomp_kernel_lanes"))
    for (label, mode), (pair, c, s, pts, mrd, fused, kw, out) in \
            timed.items():
        n_it = int(out.iters)

        def run(a=(pair, c, s, pts, mrd, fused, mode), kw=kw):
            return inner.inner_run(*a, **kw)

        def run_bufs(a=(pair, c, s, pts, mrd, fused, mode),
                     kw=dict(kw, bufs=TransitionBuffers())):
            # as the engines call it: the run's buffers, a block kept
            return inner.inner_run(*a, **kw)

        def plain(a=(pair, c, s, pts, mrd, fused, mode), kw=kw):
            return inner.inner_run_plain(*a, **kw)

        groups = kw.get("groups", 1)
        counters = kw.get("counters")

        def steps(a=(pair, c, s, pts, mrd, fused), bufs=inner.StepBuffers()):
            # the same iterations as steps: one launch each
            st = a[2]
            cnt = counters
            for _ in range(n_it):
                st, cnt, _ = inner.inner_step(*a[:2], st, *a[3:],
                                              groups=groups, counters=cnt,
                                              bufs=bufs)
            return st
        ms, pms = _median_ms(run_bufs), _median_ms(plain, n=5)
        ms_new = _median_ms(run)
        launches, memsets = _launches_memsets(run_bufs)
        _require(launches == 1 and memsets == 0,
                 f"inner_run {label} {mode}: one kernel launch and no "
                 f"memset a call with the run's buffers: {launches} "
                 f"launches, {memsets} memsets")
        try:
            dms = _device_ms(run_bufs, n=10)
        except RuntimeError as e:          # a graph the card would not take
            print(f"inner_run {label} {mode}: no CUDA graph ({e})",
                  flush=True)
            dms = None
        sms = _device_ms(steps, n=5)
        if isinstance(pair, LaneTables):
            tabs = [pair.weights, pair.cell_coords, pair.nearest_cell,
                    pair.consts, pair.cell_compat, pair.prop_onehot,
                    pair.data_mask]
        else:
            tabs = [pair.weights, pair.grid.cell_coords,
                    pair.grid.nearest_cell, pair.grid.consts,
                    pair.cell_compat, pair.prop_onehot, pair.data_mask]
        bms, bby, ops = _run_bound(pair, out, c, fused,
                                   [s[f] for f in s] + [pts, mrd], tabs)
        if mode == "search" and label.startswith("syn07 fused, corner"):
            k.update(ms=ms, plain_ms=pms, graph_ms=dms, bound_ms=bms,
                     bound_by=bby, iterations=n_it,
                     steps_graph_ms=sms, ms_block_a_call=ms_new)
        per = "not measured" if dms is None else f"{dms / n_it:.4f} ms"
        host = "not measured" if dms is None else f"{ms - dms:.4f} ms"
        print(f"inner_run timed, {label}, mode {mode}: L={pts.shape[0]} "
              f"{n_it} iterations in one launch ({int(out.resident)} lanes "
              f"resident): {ms:.4f} ms with the run's buffers (host "
              f"{host}; 1 launch, 0 memsets; a block built and outputs "
              f"allocated a call {ms_new:.4f} ms) (from a graph "
              f"{'not measured' if dms is None else f'{dms:.4f} ms'}, "
              f"{per} an iteration); the same iterations as inner_step "
              f"launches from a graph {sms:.4f} ms ({sms / n_it:.4f} ms an "
              f"iteration; K3 + K4 alone {k3k4:.4f} ms a launch); plain "
              f"loop {pms:.4f} ms; bound {bms:.6f} ms ({bby}; {ops} "
              f"operations) {floor}", flush=True)


def _tree_diff(got, want, where=""):
    """The fields of two (nested) results that differ: float32 bit for
    bit, NaN to NaN, other types exactly."""
    import torch
    bad = []
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            bad += _tree_diff(g, w, f"{where}{k}.")
            continue
        if not isinstance(w, torch.Tensor):
            if g != w:
                bad.append(f"{where}{k}: {g} vs {w}")
            continue
        if w.dtype == torch.float32:
            ok = g.shape == w.shape and bool(torch.all(
                (g.view(torch.int32) == w.view(torch.int32))
                | (torch.isnan(g) & torch.isnan(w))))
        else:
            ok = g.shape == w.shape and torch.equal(g, w)
        if not ok:
            bad.append(f"{where}{k}: {_first_diff(g.cpu(), w.cpu())}")
    return bad


# the streams' transition cases of phase 2 (row 0 edited)
STREAM_TRANSITION_CASES = ("as run", "improved by the BnB candidate",
                           "improved by the ICP", "converging", "NaN lane",
                           "INF lbs", "full frontier")


def _sorted_rest(lbs):
    """Each row of lbs ascending with no NaN: what goicp_advance's merge
    path requires of the frontier (every engine keeps it so)."""
    import torch
    return not bool(torch.isnan(lbs).any()) and bool(
        (lbs[..., 1:] >= lbs[..., :-1]).all())


def _stream_case(s0, case, c, dev):
    """A copy of a window state edited into one of
    STREAM_TRANSITION_CASES (its first row not converged, e, edited), the
    rows that transition (those not converged: e first) and the refine
    block they take."""
    import torch
    from goicp_tpu_torch.search import fused_stream as fs
    from goicp_tpu_torch.search import transition as tr
    s = fs._map_state(torch.clone, s0)
    ist = s["inner"]
    rows = [w for w in range(s["opt_err"].shape[0])
            if not bool(s["converged"][w])]
    e = rows[0]
    r = None
    if case.startswith("improved"):
        h = tr.harvest_plain(s, rows)
        s["opt_err"][e] = h["cand_ub"][0] * 2 + 1
        r = tr.dummy_refine_rows(len(rows), dev)
        h = tr.harvest_plain(s, rows)
        factor = 0.5 if case.endswith("ICP") else 2.0
        tr.set_refine(r, 0, dict(
            icp_R=torch.tensor([[0., -1., 0.], [1., 0., 0.], [0., 0., 1.]],
                               device=dev),
            icp_t=torch.tensor([0.01, -0.02, 0.03], device=dev),
            icp_err=h["incumbent"][0] * factor,
            icp_terms=torch.tensor([1.5, 0.25, 0.0], device=dev),
            icp_incomp=torch.tensor(7, dtype=torch.int32, device=dev),
            bnb_comp=torch.tensor(5, dtype=torch.int32, device=dev)))
    elif case == "converging":
        s["opt_err"][e] = 1e-9
        ist["opt_err"][e] = torch.clamp(ist["opt_err"][e], min=1.0)
    elif case == "NaN lane":
        ist["opt_err"][e, int(torch.argmax(s["active"][e].to(torch.int32)))] \
            = float("nan")
    elif case == "INF lbs":
        ist["lbs"][e, :, 1] = float("inf")
        ist["thr"][e, 1] = float("inf")
        ist["min_dropped"][e, 2] = float("inf")
        s["fr_lbs"][e, 1:] = float("inf")
    elif case == "full frontier":
        Cr = c.device_rot_capacity
        g = torch.Generator(device="cpu").manual_seed(3)
        s["fr_lbs"][e] = torch.sort(torch.rand(Cr, generator=g)).values.to(
            dev) * 50.0
        nodes = torch.rand((Cr, 4), generator=g).to(dev) * 6.0 - 3.0
        nodes[:, 3] = 0.7853982
        s["fr_nodes"][e] = nodes
        s["opt_err"][e] = 1e3
    return s, rows, r


def _transition_checks(kernels, cfg, cfg_t, pools, dev, floor):
    """Phase 2's check of the transition kernels (csrc/transition.cu,
    search/transition.py): goicp_harvest and goicp_advance held to
    harvest_plain and advance_plain, the torch code of the engines, on the
    same card tensors, every output field bit for bit (NaN to NaN), in
    every mode.  The streams' ("both"): windows of the similar pool
    (syn02, syn03, syn00, syn01), the trimmed pool (trm00 + trm01) and the
    similar pool without corner reuse (syn02 + syn03), each 40 global
    iterations into
    its fused stream, every non-converged row transitioning, in each case
    of STREAM_TRANSITION_CASES; the outputs as new tensors and written in
    place into a copy of the window (the fused stream's way), both equal.
    register_device's: syn07 from its first state and 5 outer steps in,
    the pop (and the sharded engine's pop with a given min_lb), the inner
    search from the pop's lanes, the harvest, the adoption with and
    without a refine block and of a frozen row.  The batch engine's: the
    pop of rows 0 and 2 of a 3-row batch into B-row outputs, the harvest,
    and the adoption written in place, one row frozen.  Timed: harvest and
    advance at the streams' shape (syn02 + syn03, both rows) and at
    register_device's (syn07: pop, harvest, adopt).  Every frontier the
    merge reads is checked sorted and NaN-free first (the merge path's
    precondition).  The bound: bytes, what each kernel must read
    (harvest_reads, advance_reads: the fields it reads, each once, not
    the whole state it is handed) and the outputs written once, against
    the operations (the rotated points 15 a point, the rotation uncertainty
    1, the root corners' counts CHEM_OPS a corner and real point, the
    lanes' lb minimum 1 a frontier entry) over the fp32 peak."""
    import torch
    from goicp_tpu_torch.bench.measure import (_bucket_and_prepare,
                                               _normalized_synthetic)
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.search import device_engine as eng
    from goicp_tpu_torch.search import fused_stream as fs
    from goicp_tpu_torch.search import inner
    from goicp_tpu_torch.search import transition as tr
    from goicp_tpu_torch.search.args import TransitionBuffers
    kh, ka = kernels["harvest"], kernels["advance"]

    def same(got, want, where):
        torch.cuda.synchronize()
        bad = _tree_diff(got, want)
        _require(not bad, f"{where}: kernel == plain bit for bit: {bad}")
        kh["errs"].append(0.0)
        ka["errs"].append(0.0)

    windows = {}
    for label, names, c in (
            ("similar", ("syn02", "syn03", "syn00", "syn01"), cfg),
            ("trimmed", ("trm00", "trm01"), cfg_t),
            ("similar, no corner reuse", ("syn02", "syn03"),
             dataclasses.replace(cfg, chem_reuse=0)),
            ("similar, rot_batch 4 (4 lanes a cluster block)",
             ("syn02", "syn03"), dataclasses.replace(cfg, rot_batch=4))):
        pairs = _bucket_and_prepare(
            [_normalized_synthetic(pools[n]) for n in names], c, device=dev)
        pb = stack_pairs(pairs)
        s0 = fs.fused_run_chunk(pb, c, fs._init_batch(pb, c), 40)
        tabs = fs._transition_tables(pb, c)
        windows[label] = (pb, c, s0, tabs)
        for case in STREAM_TRANSITION_CASES:
            s, rows, r = _stream_case(s0, case, c, dev)
            _require(_sorted_rest(s["fr_lbs"][rows]),
                     f"the merge's precondition: a sorted, NaN-free "
                     f"frontier ({label}, {case})")
            h = tr.harvest(c, s, rows)
            same(h, tr.harvest_plain(s, rows), f"harvest ({label}, {case})")
            got = tr.advance("both", c, pb, s, rows, tables=tabs, h=h, r=r)
            want = tr.advance_plain("both", c, pb, s, rows, h=h, r=r)
            same(got, want, f"advance both ({label}, {case})")
            win = fs._map_state(torch.clone, s)
            tr.advance("both", c, pb, win, rows, tables=tabs, h=h, r=r,
                       out=win)
            idx = torch.tensor(rows, device=dev)
            same(fs._map_state(lambda x: x[idx], win), want,
                 f"advance both in place ({label}, {case})")
            # the main path's way: the harvest's outputs from a run's two
            # sets, the blocks kept; twice, so that both sets serve
            bufs = TransitionBuffers()
            for turn in range(2):
                hb = tr.harvest(c, s, rows, bufs=bufs)
                same(hb, h, f"harvest into the sets ({label}, {case}, "
                     f"turn {turn})")
                got = tr.advance("both", c, pb, s, rows, tables=tabs, h=hb,
                                 r=r, bufs=bufs)
                same(got, want, f"advance both into the sets ({label}, "
                     f"{case}, turn {turn})")
            win = fs._map_state(torch.clone, s)
            tr.advance("both", c, pb, win, rows, tables=tabs, h=hb, r=r,
                       out=win, bufs=bufs)
            same(fs._map_state(lambda x: x[idx], win), want,
                 f"advance both in place, a kept block ({label}, {case})")
            if case == "improved by the ICP":
                _require(bool(got["last_icp"][0]), "the ICP's row adopted")
            if case == "converging":
                _require(bool(got["converged"][0]), "the row converged")
            if case == "full frontier":
                _require(bool(torch.isfinite(got["min_dropped"][0])),
                         "the full frontier dropped finite lbs")
        print(f"transition, the streams ({label}, {len(names)} rows): "
              f"harvest and advance (both modes' outputs, new, in place "
              f"and from a run's two output sets) bit for bit in "
              f"{len(STREAM_TRANSITION_CASES)} cases", flush=True)

    # a kept block whose tensor was replaced is re-checked and repointed,
    # not launched with the old pointer: the harvest and the advance of a
    # window whose incumbents are replaced by other values
    pb, c, s0, tabs = windows["similar"]
    rows = [w for w in range(s0["opt_err"].shape[0])
            if not bool(s0["converged"][w])]
    bufs = TransitionBuffers()
    for _ in range(2):
        h0 = tr.harvest(c, s0, rows, bufs=bufs)
        tr.advance("both", c, pb, s0, rows, tables=tabs, h=h0, bufs=bufs)

    def checked():
        """(blocks kept, slots re-checked in them) over bufs' sites."""
        blocks = list(bufs.blocks.values())
        return len(blocks), sum(b.rechecked for b in blocks)
    before = checked()
    s2 = dict(s0, opt_err=torch.full_like(s0["opt_err"], -1.0))
    h2 = tr.harvest(c, s2, rows, bufs=bufs)
    same(h2, tr.harvest_plain(s2, rows), "harvest, a replaced tensor")
    _require(not torch.equal(h2["incumbent"], h0["incumbent"]),
             "the replaced incumbents change the harvest")
    got = tr.advance("both", c, pb, s2, rows, tables=tabs, h=h2, bufs=bufs)
    same(got, tr.advance_plain("both", c, pb, s2, rows, h=h2),
         "advance both, a replaced tensor")
    after = checked()
    # each call found no block of its tensors: a new one was built (or
    # an old one re-checked where its tensors differ)
    _require(after[0] + after[1] >= before[0] + before[1] + 2,
             f"a block built or re-checked for each call with the "
             f"replaced tensor: {before} -> {after}")
    rechecked = f"{after[0] - before[0]} blocks built, " \
        f"{after[1] - before[1]} slots re-checked"
    print(f"transition, kept blocks: a replaced tensor not launched with "
          f"the old pointer ({rechecked}), harvest and advance "
          f"bit for bit with the plain versions on the new values",
          flush=True)

    # register_device's: one row, pop / harvest / adopt
    pair = _prepared("syn07", cfg, pools, dev)
    pb1, tabs1 = eng._one_row(pair, cfg)
    st0 = eng.device_init(pair, cfg)
    timed1 = None
    cfg4 = dataclasses.replace(cfg, rot_batch=4)
    pb4, tabs4 = eng._one_row(pair, cfg4)
    s4 = eng._as_row(eng.device_init(pair, cfg4))
    for ml in (None, s4["fr_lbs"][:, 0] * 0.5):
        same(tr.advance("pop", cfg4, pb4, s4, [0], tables=tabs4, min_lb=ml),
             tr.advance_plain("pop", cfg4, pb4, s4, [0], min_lb=ml),
             "advance pop (syn07, rot_batch 4)")
    for label, st in (("first state", st0),
                      ("5 outer steps in",
                       eng.device_run_chunk(pair, cfg, st0, 5))):
        s1 = eng._as_row(st)
        _require(_sorted_rest(s1["fr_lbs"]),
                 f"the merge's precondition (syn07 {label})")
        for ml in (None, st["fr_lbs"][:1] * 0.5):
            got = tr.advance("pop", cfg, pb1, s1, [0], tables=tabs1,
                             min_lb=ml)
            same(got, tr.advance_plain("pop", cfg, pb1, s1, [0], min_lb=ml),
                 f"advance pop (syn07 {label}, min_lb "
                 f"{'given' if ml is not None else 'the frontier'})")
        p = got
        res, lanes = inner.inner_bnb(
            pair, cfg, p["pts"][0], p["widths"][0], p["active"][0],
            st["opt_err"], False, True,
            lanes0={k: v[0] for k, v in p["lanes"].items()},
            mrd=p["mrd"][0], raw=True)
        src = eng._harvest_src(dict(batch=p), st["opt_err"], res)
        lb = eng._lb_lanes(lanes)
        h = tr.harvest(cfg, src, [0], lb=lb, conv=p["converged"])
        same(h, tr.harvest_plain(src, [0], lb=lb, conv=p["converged"]),
             f"harvest (syn07 {label})")
        r = tr.dummy_refine_rows(1, dev)
        tr.set_refine(r, 0, dict(
            icp_R=torch.eye(3, device=dev), icp_t=torch.zeros(3, device=dev),
            icp_err=h["incumbent"][0] * 0.5, icp_terms=torch.ones(3,
                                                                  device=dev),
            icp_incomp=torch.tensor(3, dtype=torch.int32, device=dev),
            bnb_comp=torch.tensor(2, dtype=torch.int32, device=dev)))
        work = eng._work(res, res, True)
        for rr, frozen in ((None, False), (r, False), (None, True)):
            sa = dict(s1, converged=torch.ones_like(s1["converged"])) \
                if frozen else s1
            got = tr.advance("adopt", cfg, pb1, sa, [0], tables=tabs1, h=h,
                             r=rr, p=p, work=work)
            same(got, tr.advance_plain("adopt", cfg, pb1, sa, [0], h=h, r=rr,
                                       p=p, work=work),
                 f"advance adopt (syn07 {label}, "
                 f"{'refined' if rr is not None else 'no refine'}"
                 f"{', frozen' if frozen else ''})")
        timed1 = (st, p, h, work)
        print(f"transition, register_device (syn07 {label}): pop (and "
              f"with a given min_lb), harvest, adopt (no refine, refined, "
              f"frozen) bit for bit", flush=True)

    # the batch engine's: rows 0 and 2 of three, B-row outputs
    pb3, c3 = windows["similar"][0], cfg
    pb3 = pb3.map_tensors(lambda t: t[:3].contiguous())
    tabs3 = fs._transition_tables(pb3, c3)
    sb = eng.batch_init(pb3, c3)
    rows = [0, 2]
    nd = pb3.n_data_padded
    outs = [tr.outputs("pop", c3, 3, nd, dev) for _ in range(2)]
    got = tr.advance("pop", c3, pb3, sb, rows, tables=tabs3, out=outs[0])
    want = tr.advance_plain("pop", c3, pb3, sb, rows, out=outs[1])
    idx = torch.tensor(rows, device=dev)
    same(fs._map_state(lambda x: x[idx], got),
         fs._map_state(lambda x: x[idx], want), "advance pop into B rows")
    outs2 = [tr.outputs("pop", c3, 2, nd, dev) for _ in range(2)]
    same(tr.advance("pop", c3, pb3, sb, rows, tables=tabs3, out=outs2[0],
                    out_rows=[1, 0]),
         tr.advance_plain("pop", c3, pb3, sb, rows, out=outs2[1],
                          out_rows=[1, 0]),
         "advance pop into out_rows [1, 0]")
    src = dict(inner=got["lanes"], active=got["active"],
               R_lanes=got["R_lanes"], opt_err=sb["opt_err"])
    h = tr.harvest(c3, src, rows, conv=got["converged"])
    same(h, tr.harvest_plain(src, rows, conv=got["converged"]),
         "harvest of B rows")
    got["converged"][2] = True          # row 2 frozen
    zero = torch.zeros(3, dtype=torch.int32, device=dev)
    work = dict(evals=zero + 5, iters=zero + 2, geom_surv=zero + 3,
                chem_corners=zero + 7)
    s_k, s_p = (fs._map_state(torch.clone, sb) for _ in range(2))
    tr.advance("adopt", c3, pb3, s_k, rows, tables=tabs3, h=h, p=got,
               work=work, out=s_k)
    tr.advance_plain("adopt", c3, pb3, s_p, rows, h=h, p=got, work=work,
                     out=s_p)
    same(s_k, s_p, "advance adopt in place into B rows (one frozen)")
    print("transition, the batch engine (rows 0 and 2 of 3): pop into "
          "B-row outputs and at out_rows, harvest, adopt in place with a "
          "frozen row, bit for bit", flush=True)

    # times: the streams' shape (syn02 + syn03, both rows transitioning)
    # and register_device's (syn07: pop, harvest, adopt)
    L = cfg.rot_batch * 8
    pb2 = windows["similar"][0].map_tensors(lambda t: t[:2].contiguous())
    s02 = fs._map_state(lambda x: x[:2].contiguous(), windows["similar"][2])
    tabs2 = fs._transition_tables(pb2, cfg)
    rows2 = [0, 1]
    h2 = tr.harvest(cfg, s02, rows2)
    st1, p1, _, work1 = timed1
    s1 = eng._as_row(st1)
    src1 = eng._harvest_src(dict(batch=p1), st1["opt_err"], res)
    lb1 = eng._lb_lanes(lanes)
    h1 = tr.harvest(cfg, src1, [0], lb=lb1)

    # the main path's calls: the run's TransitionBuffers kept (blocks
    # reused, outputs from the two sets; the stream's advance in place;
    # register_device's calls given the 1-row views made anew a call, as
    # its outer step makes them); `per_call=True`: without them (a block
    # built and outputs allocated a call: the packed stream's way)
    bufs2, bufs1 = TransitionBuffers(), TransitionBuffers()
    win2 = fs._map_state(torch.clone, s02)

    def stream_h(plain=False, per_call=False):
        if plain:
            return tr.harvest_plain(s02, rows2)
        return tr.harvest(cfg, s02, rows2,
                          bufs=None if per_call else bufs2)

    def stream_a(plain=False, per_call=False):
        if plain:
            return tr.advance_plain("both", cfg, pb2, s02, rows2, h=h2)
        if per_call:
            return tr.advance("both", cfg, pb2, s02, rows2, tables=tabs2,
                              h=h2)
        return tr.advance("both", cfg, pb2, win2, rows2, tables=tabs2,
                          h=h2, out=win2, bufs=bufs2)

    def one_h(plain=False, per_call=False):
        if plain:
            return tr.harvest_plain(src1, [0], lb=lb1)
        return tr.harvest(cfg, eng._harvest_src(dict(batch=p1),
                                                st1["opt_err"], res), [0],
                          lb=eng._lb_lanes(lanes),
                          bufs=None if per_call else bufs1)

    def one_a(plain=False, per_call=False):
        if plain:
            return (tr.advance_plain("pop", cfg, pb1, s1, [0]),
                    tr.advance_plain("adopt", cfg, pb1, s1, [0], h=h1, p=p1,
                                     work=work1))
        b = None if per_call else bufs1
        return (tr.advance("pop", cfg, pb1, eng._as_row(st1), [0],
                           tables=tabs1, bufs=b),
                tr.advance("adopt", cfg, pb1, eng._as_row(st1), [0],
                           tables=tabs1, h=h1, p=p1, work=work1, bufs=b))

    def per_row(x):
        """One row's bytes of a tensor whose first axis is the rows."""
        return x.numel() * x.element_size() // x.shape[0]

    def harvest_reads(src, lb=None):
        """The bytes goicp_harvest reads a row: each lane's lb fields
        (its frontier's lbs, thr, min_dropped, done), active flag and ub,
        the argmin lane's best node, R and terms, the row's incumbent."""
        lst = src["inner"] if lb is None else lb
        ist = src["inner"]
        L = src["active"].shape[1]
        return (sum(per_row(lst[k]) for k in ("lbs", "thr", "min_dropped",
                                              "done"))
                + per_row(src["active"]) + per_row(ist["opt_err"])
                + (per_row(ist["best_node"]) + per_row(ist["ub_terms"])
                   + per_row(src["R_lanes"])) // L
                + per_row(src["opt_err"]))

    def advance_reads(mode, s, pb, tabs, children, lb_safe):
        """The bytes goicp_advance reads a row in `mode`: adopt (adopt,
        both) the frontier's rest (all of it in both), the children's
        nodes, active flags and lb_safe, and the row's scalars (the
        improved flag, the incumbent and the R, t, terms, comp and
        last_icp it is picked from, min_dropped, the counters and the
        inner search's, and in adopt the pop's converged and final_lb);
        pop (pop, both) the parents (pop alone: adopt hands them over in
        shared memory), sse, converged, final_lb, each pair's data and
        point norms once, and under corner reuse K2's tables."""
        Pr, Cr = cfg.rot_batch, cfg.device_rot_capacity
        node = 20                               # an lb and a node
        b = 0
        if mode != "pop":
            b += (Cr - (Pr if mode == "adopt" else 0)) * node
            b += per_row(children["child_nodes"]) \
                + per_row(children["active"]) + per_row(lb_safe)
            b += 1 + 4 + 36 + 12 + 12 + 4 + 1 + 4 + 5 * 4 + 4 * 4
            b += 4 if isinstance(s.get("it"), torch.Tensor) else 0
            b += 1 + 1 + 4 if mode == "adopt" else 0
        if mode != "adopt":
            b += (Pr * node + 4 if mode == "pop" else 0) + 4 + 1 + 4
            b += per_row(pb.data) + per_row(pb.norm_data)
            if inner._chem_reuse_active(cfg):
                b += sum(per_row(x) for x in (
                    tabs.cell_compat, tabs.prop_onehot, tabs.data_mask,
                    tabs.nearest_cell, tabs.consts))
        return b

    def written(out):
        return sum(_nbytes(*_leaves(o)) for o in out)

    def lane_ops(nd, real, rows):
        # the rotated points 15 and the uncertainty 1 a point, the root
        # corners' counts
        return rows * (L * nd * 16 + 8 * L * real * CHEM_OPS)

    two = _bucket_and_prepare([_normalized_synthetic(pools[n])
                               for n in ("syn02", "syn03")], cfg, device=dev)
    for shape, fh, fa, h_read, h_ops, a_read, a_ops in (
            ("the streams' shape (syn02 + syn03)", stream_h, stream_a,
             2 * harvest_reads(s02), s02["inner"]["lbs"].numel(),
             2 * advance_reads("both", s02, pb2, tabs2, s02, h2["lb_safe"]),
             lane_ops(pb2.n_data_padded,
                      max(_real_points(q) for q in two), 2)),
            ("register_device's shape (syn07)", one_h, one_a,
             harvest_reads(src1, lb1), lb1["lbs"].numel(),
             advance_reads("pop", s1, pb1, tabs1, None, None)
             + advance_reads("adopt", s1, pb1, tabs1, p1, h1["lb_safe"]),
             lane_ops(pb1.n_data_padded, _real_points(pair), 1))):
        times = {}
        for name, fn, reads, ops in (("harvest", fh, h_read, h_ops),
                                     ("advance", fa, a_read, a_ops)):
            out = fn()
            out = out if isinstance(out, tuple) else (out,)
            # `improved` is a view of `flags`
            nbytes = reads + written(
                {k: v for k, v in o.items() if k != "improved"} for o in out)
            t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
            times[name] = dict(
                ms=_median_ms(fn), graph_ms=_device_ms(fn),
                ms_per_call_block=_median_ms(
                    lambda fn=fn: fn(per_call=True)),
                plain_ms=_median_ms(lambda fn=fn: fn(plain=True)),
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None)
            v = times[name]
            print(f"transition timed, {shape}: {name} kernel "
                  f"{v['ms']:.4f} ms with the run's buffers (a block built "
                  f"and outputs allocated a call: "
                  f"{v['ms_per_call_block']:.4f} ms; from a graph "
                  f"{v['graph_ms']:.4f} ms) "
                  f"plain {v['plain_ms']:.4f} ms bound {v['bound_ms']:.6f} "
                  f"ms ({v['bound_by']}; {nbytes} bytes, {ops} operations) "
                  f"{floor}", flush=True)
        if shape.startswith("the streams"):
            kh.update(times["harvest"])
            ka.update(times["advance"])
        else:
            kh["register_device_shape"] = times["harvest"]
            ka["register_device_shape"] = times["advance"]


def _leaves(d):
    """The tensors of a (nested) dict."""
    import torch
    out = []
    for v in d.values():
        if isinstance(v, dict):
            out += _leaves(v)
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def _icp_checks(kernels, cfg, cfg_t, pools, dev, floor):
    """Phase 2's check of csrc/icp.cu: icp_run (one launch an ICP event)
    against icp_run_plain (the host loop of torch ops, its sums and
    products launching the fixed-order kernels) on the same card tensors,
    bit for bit in R, t, nn_idx, err and iters, in every mask mode, on
    bench/icp_stops.py's events: syn07 with the outer step's 4 seeds
    untrimmed (its real points) and as the engine calls it on its padded
    bucket (data_mask and count) with row 1 disabled, trm00 with count +
    dynamic_trim and with a static trim, the demo's 1000 / 500 points, one
    row of 4,200 / 4,200 points, whose workspace does not fit shared
    memory and lies in device memory, syn07's bucket as the fused stream
    refines one row (K = 1) and from the 8 initial seeds (K = 8), and 165
    / 306 and 306 / 306 points (the bench's smallest and largest clouds).
    Each event's time an iteration is its graph_ms over its longest row's
    iterations.  syn07's untrimmed event is also timed as the plain loop
    (the kernels line's numbers; no one PyTorch call computes either
    function) and shown to be one launch and no memset.  ptxas's stack
    frame and spills of the ICP kernel are 0.  Then kabsch3 against
    kabsch_from_H on degenerate H (zero, rank 1, rank 2, a reflection) and
    seeded ones."""
    import numpy as np
    import torch
    from goicp_tpu_torch import _build
    from goicp_tpu_torch.bench.icp_stops import (BIG_POINTS, icp_events,
                                                 kernel_info)
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    from goicp_tpu_torch.icp import icp as ticp
    rng = np.random.default_rng(13)
    K = cfg.icp_seeds
    f32 = dict(dtype=torch.float32, device=dev)
    info = kernel_info(_build.build_info.get("log", ""))
    _require(info, "ptxas's report for the ICP kernel is in the build's "
             "log (kept beside the library, read back when it is cached)")
    _require(any("0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                 "spill loads" in x for x in info),
             f"the ICP kernel has no stack frame and no spills: {info}")
    cases = icp_events(cfg, cfg_t, pools, dev)
    _require(4 * (10 + 4) * BIG_POINTS > ticp.ICP_SMEM_BYTES,
             "the 4,200-point event's workspace does not fit shared memory")
    k = kernels["icp_run"]
    for i, (label, data, model, R0, t0, kw) in enumerate(cases):
        nd, m = data.shape[0], model.shape[0]

        def kern(a=(data, model, R0, t0), kw=kw):
            return ticp.icp_run(*a, **kw)

        def plain(a=(data, model, R0, t0), kw=kw):
            return ticp.icp_run_plain(*a, **kw)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        _require(_same_bits([got.R, got.t, got.err], [want.R, want.t,
                                                      want.err])
                 and torch.equal(got.nn_idx, want.nn_idx)
                 and torch.equal(got.iters, want.iters),
                 f"icp_run == icp_run_plain bit for bit ({label}): iters "
                 f"{got.iters.tolist()} vs {want.iters.tolist()}, err "
                 f"{got.err.tolist()} vs {want.err.tolist()}")
        err = _max_err([got.R, got.t, got.err], [want.R, want.t, want.err])
        k["errs"].append(err)
        mode = ticp.icp_mode(nd, kw["inlier_num"], kw.get("count"),
                             kw.get("data_mask"), kw.get("dynamic_trim",
                                                         False))
        ms, dms = _median_ms(kern, n=7), _device_ms(kern, n=5, reps=3)
        longest = max(1, int(got.iters.max()))
        bms, bby = _icp_bound(got, nd, m, mode,
                              [data, model, R0, t0, kw.get("data_mask")])
        times = (f"kernel {ms:.4f} ms (from a graph {dms:.4f} ms, "
                 f"{dms / longest * 1e3:.3f} us an iteration of the longest "
                 f"row)")
        if i == 0:
            pms = _median_ms(plain, n=5)
            k.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                     graph_ms=dms, library_ms=None)
            times += f" plain {pms:.4f} ms"
            launches, memsets = _launches_memsets(kern)
            _require(launches == 1 and memsets == 0,
                     f"icp_run is one launch and no memset an event "
                     f"({launches}, {memsets})")
            times += f"; {launches:g} launch, {memsets:g} memsets a call"
        print(f"icp_run {label}: Nd={nd} M={m} K={R0.shape[0]} mode {mode} "
              f"iters {got.iters.tolist()}: max_abs_err={err:.3g} (bit for "
              f"bit) {times} bound {bms:.6f} ms ({bby}) library none "
              f"{floor}", flush=True)
    print(f"icp_run kernel (ptxas): {info}", flush=True)

    # the Kabsch alone, on degenerate and seeded H
    H = [np.zeros((3, 3)), np.outer(rng.normal(size=3), rng.normal(size=3)),
         rng.normal(size=(3, 2)) @ rng.normal(size=(2, 3)),
         np.diag([1.0, 2.0, -3.0]) @ rodrigues_np(rng.uniform(-1, 1, 3))]
    H = torch.as_tensor(np.concatenate([np.stack(H), rng.normal(
        size=(K * 16 - len(H), 3, 3)) * 10.0 ** rng.uniform(
            -4, 3, (K * 16 - len(H), 1, 1))]), **f32)
    k = kernels["kabsch3"]

    def kern3():
        return ticp.kabsch3(H)

    def plain3():
        return ticp.kabsch_from_H(H)
    got, want = kern3(), plain3()
    torch.cuda.synchronize()
    _require(_same_bits([got], [want]), "kabsch3 == kabsch_from_H bit for "
             "bit (zero, rank 1, rank 2, a reflection, seeded H)")
    err = _max_err([got], [want])
    k["errs"].append(err)
    ms, pms, dms = _median_ms(kern3), _median_ms(plain3), _device_ms(kern3)
    bms, bby = _bound(H.shape[0], KABSCH_OPS, [H, got])
    k.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby, graph_ms=dms,
             library_ms=None)
    print(f"kabsch3: H {tuple(H.shape)} (zero, rank 1, rank 2, a reflection, "
          f"seeded): max_abs_err={err:.3g} (bit for bit) kernel {ms:.4f} ms "
          f"(from a graph {dms:.4f} ms) plain {pms:.4f} ms bound {bms:.6f} "
          f"ms ({bby}) library none {floor}", flush=True)


# per (row, real point) operations a rescoring needs (csrc/score.cu's
# step 1 and its sums): the rotation 15 and + t 3, the voxel 21, the
# table index 4, the weight, the square and the sum 3, the two
# incompatibility tests and their counts 4
SCORE_OPS = 15 + 3 + 21 + 4 + 3 + 4
# bytes per (row, real point) a rescoring gathers besides its inputs read
# once: the distance field 4, the nearest cell 4, the (point, cell)
# compat entry 1, the correspondence's model property 4
SCORE_GATHER_BYTES = 4 + 4 + 1 + 4
SCORE_FAR = 1500.0     # a shift that puts every point thousands of voxels
                       # outside the grid (squares beyond 2^24)


def _score_bound(pair, rows, tensors):
    """(bound_ms, bound_by) of a rescoring of `rows` transforms: its
    operations and gathers per (row, real point), its tensors read or
    written once."""
    n = rows * _real_points(pair)
    t_ops = n * SCORE_OPS / PEAK_OPS
    t_bytes = (_nbytes(*tensors) + n * SCORE_GATHER_BYTES) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _score_checks(k, cfg, cfg_t, pools, dev, floor):
    """Phase 2's check of csrc/score.cu (bounds/error.py's score_kernel):
    each of its routes against the torch bodies on the same card tensors,
    bit for bit.  The full route (rescore: score_transform's six fields
    and icp_chem_terms' count) on the transforms and correspondences of
    bench/icp_stops.py's ten ICP events, each rescored on the pair it
    reads (syn07's 4 seeds on its unpadded pair and on its padded bucket,
    trm00's dynamic trim and static trim, the demo's 1000 / 500 points,
    the 4,200 / 4,200 points, syn07's K = 1 and K = 8, 165 / 306 points
    with a static trim, 306 / 306), on syn07's bucket shifted SCORE_FAR
    outside its grid, and on phase 11's L1, c-FPFH and neighbour
    configurations (each option's first pair); the count route at each
    case's starts, batched and one candidate alone; the initial-error
    route on every pair.  Timed on syn07's bucket (the rescoring the
    engines run): single calls, from a CUDA graph, the torch bodies; one
    launch and no memset a call; ptxas's stack frame and spills of the
    kernel 0.  Then the card's torch.sum over a last axis of 3 against the
    orders grid/lookup.py's oob_extension could take (it writes out the
    sequential one), and dt_distance on points far outside a grid, card
    and CPU bit for bit."""
    import numpy as np
    import torch
    from goicp_tpu_torch import _build
    from goicp_tpu_torch.bench.icp_stops import (engine_kw, icp_events,
                                                 kernel_info)
    from goicp_tpu_torch.bench.measure import _normalized_synthetic
    from goicp_tpu_torch.bench.options import OPTION_PAIRS, option_config
    from goicp_tpu_torch.bounds import error as terr
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    from goicp_tpu_torch.grid.lookup import dt_distance
    from goicp_tpu_torch.icp.icp import icp_run
    from goicp_tpu_torch.pipeline.prepare import prepare_pair
    info = kernel_info(_build.build_info.get("log", ""), "score_kernel")
    _require(any("0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                 "spill loads" in x for x in info),
             f"the rescoring kernel has no stack frame and no spills: {info}")
    print(f"score_kernel (ptxas): {info}", flush=True)
    rng = np.random.default_rng(19)
    f32 = dict(dtype=torch.float32, device=dev)

    def starts(n):
        R = torch.as_tensor(np.stack([rodrigues_np(v) for v in rng.uniform(
            -0.3, 0.3, (n, 3))]), **f32)
        return R, torch.as_tensor(rng.uniform(-0.05, 0.05, (n, 3)), **f32)

    def cloud_pair(data, model, c):
        props = rng.integers(0, 9, model.shape[0]).astype(np.int32)
        dp = props[:data.shape[0]].copy()
        dp[::5] = (dp[::5] + 1) % 9
        return prepare_pair(data.cpu().numpy(), model.cpu().numpy(), dp,
                            props, c, device=dev)

    syn07 = _prepared("syn07", cfg, pools, dev)
    own = {0: (prepare_pair(*_normalized_synthetic(pools["syn07"]), cfg,
                            device=dev), cfg),
           1: (syn07, cfg), 2: (_prepared("trm00", cfg_t, pools, dev), cfg_t),
           3: (prepare_pair(*_normalized_synthetic(pools["trm00"]), cfg_t,
                            bucket=True, device=dev), cfg_t),
           6: (syn07, cfg), 7: (syn07, cfg)}
    cases = []
    for i, (label, data, model, R0, t0, kw) in enumerate(
            icp_events(cfg, cfg_t, pools, dev)):
        pair, c = own.get(i) or (
            cloud_pair(data, model, cfg_t if "static trim" in label else cfg),
            cfg_t if "static trim" in label else cfg)
        _require(pair.n_data_padded == data.shape[0],
                 f"the pair rescoring {label} has its {data.shape[0]} points")
        res = icp_run(data, model, R0, t0, **kw)
        cases.append((label, pair, c, res.R, res.t, res.nn_idx, R0, t0))
    R1, t1, nn1 = cases[1][3:6]
    cases.append((f"syn07's bucket shifted {SCORE_FAR} outside its grid",
                  syn07, cfg, R1, t1 + SCORE_FAR, nn1, R1, t1 + SCORE_FAR))
    for option in ("l1", "fpfh", "nbr"):
        name = OPTION_PAIRS[option][0]
        c = option_config(cfg, option)
        (pair,) = _option_pairs([name], c, pools, dev)
        R0, t0 = starts(cfg.icp_seeds)
        res = icp_run(pair.data, pair.model, R0, t0, **engine_kw(pair, c))
        cases.append((f"phase 11's {option} ({name})", pair, c, res.R,
                      res.t, res.nn_idx, R0, t0))

    for i, (label, pair, c, R, t, nn, R0, t0) in enumerate(cases):
        def kern(a=(pair, c, R, t, nn)):
            return terr.rescore(*a)

        def plain(a=(pair, c, R, t, nn)):
            return (terr.score_transform_plain(*a),
                    terr.icp_chem_terms(a[0], a[1], a[4])[3])
        (got, gi), (want, wi) = kern(), plain()
        counts = [(terr.bnb_incompatibility_count(pair, c, *x),
                   terr.bnb_incompatibility_count_plain(pair, c, *x))
                  for x in ((R0, t0), (R0[0], t0[0]))]
        init = (terr.initial_error(pair, c), terr.initial_error_plain(pair, c))
        torch.cuda.synchronize()
        floats = ("error", "geom", "incomp_term", "fpfh_term", "nbr_term")
        _require(_same_bits([getattr(got, f) for f in floats] + [gi],
                            [getattr(want, f) for f in floats] + [wi])
                 and torch.equal(got.incomp_count, want.incomp_count),
                 f"rescore == the torch bodies bit for bit ({label}): "
                 f"{got} vs {want}")
        _require(all(torch.equal(a, b) for a, b in counts),
                 f"the count route == bnb_incompatibility_count_plain "
                 f"({label}): {counts}")
        _require(_same_bits([init[0]], [init[1]]),
                 f"the initial-error route == initial_error_plain ({label}): "
                 f"{init}")
        err = _max_err([getattr(got, f) for f in floats] + [gi, init[0]],
                       [getattr(want, f) for f in floats] + [wi, init[1]])
        k["errs"].append(err)
        times = ""
        if i == 1:
            ms, dms, pms = _median_ms(kern), _device_ms(kern), \
                _median_ms(plain)
            bms, bby = _score_bound(pair, R.shape[0], [
                pair.data, pair.weights, pair.data_mask, pair.data_props, R,
                t, nn, got.error, got.geom, got.incomp_term, got.fpfh_term,
                got.nbr_term, got.incomp_count, gi])
            k.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                     graph_ms=dms, library_ms=None)
            launches, memsets = _launches_memsets(kern)
            _require(launches == 1 and memsets == 0,
                     f"a rescoring is one launch and no memset "
                     f"({launches}, {memsets})")
            cms = _median_ms(lambda: terr.bnb_incompatibility_count(
                pair, c, R0[0], t0[0]))
            ims = _median_ms(lambda: terr.initial_error(pair, c))
            times = (f"; kernel {ms:.4f} ms (from a graph {dms:.4f} ms) "
                     f"plain {pms:.4f} ms bound {bms:.6f} ms ({bby}) library "
                     f"none; {launches:g} launch, {memsets:g} memsets a "
                     f"call; the count route {cms:.4f} ms, the initial "
                     f"error {ims:.4f} ms; {floor}")
        trim = "none" if not c.doTrim else \
            "dynamic" if pair.dynamic_counts else "static"
        print(f"score_kernel {label}: K={R.shape[0]} Nd={pair.n_data_padded} "
              f"trim {trim} norm {c.norm} error {got.error.tolist()} "
              f"icp_incomp {gi.tolist()} counts {counts[0][0].tolist()} "
              f"initial {float(init[0]):.6g}: max_abs_err={err:.3g} (bit "
              f"for bit, all three routes){times}", flush=True)

    # the card's torch.sum over 3 terms, and the extension's written order
    x = torch.as_tensor(rng.integers(2000, 9000, (8192, 3)).astype(
        np.float32) ** 2, device=dev)
    s = torch.sum(x, dim=-1)
    orders = {"(a + b) + c": (x[:, 0] + x[:, 1]) + x[:, 2],
              "(a + c) + b": (x[:, 0] + x[:, 2]) + x[:, 1],
              "a + (b + c)": x[:, 0] + (x[:, 1] + x[:, 2])}
    same = {o: float((v == s).float().mean()) for o, v in orders.items()}
    g = syn07.grid
    far = torch.as_tensor(rng.uniform(-2000.0, 2000.0, (4096, 3)), **f32)
    card_d = dt_distance(far, g.dist, g.consts)
    cpu_d = dt_distance(far.cpu(), g.dist.cpu(), g.consts.cpu())
    _require(_same_bits([card_d.cpu()], [cpu_d]),
             "dt_distance far outside the grid: the card == the CPU bit "
             "for bit")
    print(f"torch.sum over a last axis of 3 on the card (8192 rows of "
          f"squares beyond 2^24): share equal to each order {same}; the "
          f"CPU's and XLA:CPU's order is (a + b) + c, which oob_extension "
          f"writes out; dt_distance of 4096 points far outside syn07's "
          f"grid: the card == the CPU bit for bit", flush=True)
    return cases


# bytes per lane the seeds read (ub 4, R 36, node 16) and per seed they
# write (R 36, t 12); operations per pair of lanes (the rank's comparison:
# two NaN tests, a less-than, an equality, the index test, the add) and
# per seed (t: a division and three adds)
SEEDS_LANE_BYTES, SEEDS_SEED_BYTES = 4 + 36 + 16, 36 + 12
SEEDS_PAIR_OPS, SEEDS_SEED_OPS = 6, 4


def _same_fields(got, want):
    """Every tensor of `got` equals its `want` bit for bit."""
    import torch
    return all(torch.equal(g.reshape(-1).view(torch.uint8),
                           w.reshape(-1).view(torch.uint8))
               for g, w in zip(got, want))


def _field_err(got, want):
    """max |got - want| over the float32 and int32 tensors."""
    import torch
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want)
               if g.dtype == torch.float32 or g.dtype == torch.int32)


def _pick_checks(kernels, cases, cfg, pools, dev, floor):
    """Phase 2's check of the pick (search/pick.py: csrc/score.cu's
    goicp_icp_seeds and goicp_score_pick) against its plain versions on
    the same card tensors, bit for bit.  The pick route (score_pick: the
    rescoring of K ICP results, the first best, the candidate's count,
    into row 1 of a 3-row refine record) and the initial route
    (score_initial) on each of _score_checks' cases (the ten ICP events'
    results, syn07 far outside its grid, phase 11's options) at K = 1, 4
    and 8 where the event has that many rows, and on the rows repeated
    twice and three times (tied errors: the first wins; above 8 rows the
    ticket form); the seeds (icp_seeds: the K lowest-ub of 64 lanes,
    syn07's first 8 eight times over, ties to the lower lane) at K = 1,
    4, 8, 12 on distinct ubs, on ubs of five values (ties), with inactive
    lanes (inf) and a NaN lane, the first also resetting a record.  Timed on syn07's bucket (4 seeds,
    the engines' refinement): single calls, from a CUDA graph, the plain
    versions; one launch and no memset a call; ptxas's stack frame and
    spills of both kernels 0."""
    import numpy as np
    import torch
    from goicp_tpu_torch import _build
    from goicp_tpu_torch.bench.icp_stops import kernel_info
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    from goicp_tpu_torch.search import device_engine as eng
    from goicp_tpu_torch.search import pick
    from goicp_tpu_torch.search.args import RefineRows
    log = _build.build_info.get("log", "")
    for kname in ("pick_kernel", "icp_seeds_kernel"):
        info = kernel_info(log, kname)
        _require(info and all("0 bytes stack frame, 0 bytes spill stores, "
                              "0 bytes spill loads" in x
                              for x in info if "stack frame" in x),
                 f"{kname} has no stack frame and no spills: {info}")
        print(f"{kname} (ptxas): {info}", flush=True)
    ks, kp, ki = (kernels[k] for k in ("icp_seeds", "score_pick",
                                       "score_initial"))
    f32 = dict(dtype=torch.float32, device=dev)
    rng = np.random.default_rng(20)

    def record(n=3):
        rec = RefineRows(n, dev)
        for v in rec.values():      # a state no route writes
            v.view(torch.uint8).copy_(torch.as_tensor(
                rng.integers(0, 2, v.view(torch.uint8).shape), device=dev))
        return rec

    same, err = _same_fields, _field_err
    for i, (label, pair, c, R, t, nn, R0, t0) in enumerate(cases):
        K = R.shape[0]
        shapes = [(f"K={k}", R[:k], t[:k], nn[:k]) for k in (1, 4, 8)
                  if k <= K]
        shapes += [(f"K={m * K} (the rows {m}x: ties"
                    + ("; tickets)" if m * K > pick.CLUSTER else ")"),
                    R.repeat(m, 1, 1), t.repeat(m, 1), nn.repeat(m, 1))
                   for m in (2, 3)]
        cand = (R0[0].contiguous(), t0[0].contiguous())
        for sub, Rk, tk, nk in shapes:
            Rk, tk, nk = Rk.contiguous(), tk.contiguous(), nk.contiguous()
            got, want = record(), None
            want = RefineRows(3, dev)
            for k_, v in got.items():
                want[k_].copy_(v)
            pick.score_pick(pair, c, Rk, tk, nk, *cand, got, 1)
            pick.score_pick_plain(pair, c, Rk, tk, nk, *cand, want, 1)
            gi = pick.score_initial(pair, c, Rk, tk, nk)
            wi = pick.score_initial_plain(pair, c, Rk, tk, nk)
            torch.cuda.synchronize()
            g1, w1 = list(got.values()), list(want.values())
            g2, w2 = list(gi.values()), list(wi.values())
            _require(same(g1, w1),
                     f"score_pick == score_pick_plain bit for bit ({label}, "
                     f"{sub}): {dict(got)} vs {dict(want)}")
            _require(same(g2, w2),
                     f"score_initial == score_initial_plain bit for bit "
                     f"({label}, {sub}): {gi} vs {wi}")
            kp["errs"].append(err(g1, w1))
            ki["errs"].append(err(g2, w2))
        line = ""
        if i == 1:
            rec, rec_p = record(), record()

            def kern(a=(pair, c, R, t, nn, *cand, rec, 1)):
                return pick.score_pick(*a)

            def plain(a=(pair, c, R, t, nn, *cand, rec_p, 1)):
                return pick.score_pick_plain(*a)

            def kern_i(a=(pair, c, R, t, nn)):
                return pick.score_initial(*a)

            def plain_i(a=(pair, c, R, t, nn)):
                return pick.score_initial_plain(*a)
            line = ";"
            for k, (fk, fp), what in ((kp, (kern, plain), "pick"),
                                      (ki, (kern_i, plain_i), "initial")):
                ms, dms, pms = _median_ms(fk), _device_ms(fk), _median_ms(fp)
                outs = list(rec.values()) if what == "pick" \
                    else list(kern_i().values())
                bms, bby = _score_bound(pair, K + 1, [
                    pair.data, pair.weights, pair.data_mask,
                    pair.data_props, R, t, nn, *cand, *outs])
                launches, memsets = _launches_memsets(fk)
                _require(launches == 1 and memsets == 0,
                         f"the {what} route is one launch and no memset a "
                         f"call ({launches}, {memsets})")
                k.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                         graph_ms=dms, library_ms=None)
                line += (f" the {what} route {ms:.4f} ms (from a graph "
                         f"{dms:.4f} ms) plain {pms:.4f} ms bound "
                         f"{bms:.6f} ms ({bby}), {launches:g} launch, "
                         f"{memsets:g} memsets a call;")
            line += f" {floor}"
        print(f"score_pick / score_initial {label}: K={K} "
              f"Nd={pair.n_data_padded}, at {', '.join(x[0] for x in shapes)}:"
              f" max_abs_err={max(kp['errs'][-len(shapes):]):.3g} / "
              f"{max(ki['errs'][-len(shapes):]):.3g} (bit for bit, every "
              f"field of the record and of the state){line}", flush=True)

    # the seeds: syn07's first outer step's lanes, 8 times over (64 lanes,
    # the host engine's width; the bench shape pops 8)
    syn07 = cases[1][1]
    R_lanes = eng._pop(syn07, cfg, eng.device_init(syn07, cfg))[
        "R_lanes"].repeat(8, 1, 1).contiguous()
    L = R_lanes.shape[0]
    nodes = torch.as_tensor(np.concatenate(
        [rng.uniform(-0.05, 0.05, (L, 3)), rng.uniform(0.01, 0.1, (L, 1))],
        axis=1), **f32)
    distinct = rng.uniform(0.5, 2.0, L)
    five = rng.integers(0, 5, L).astype(np.float64)
    holes = distinct.copy()
    holes[rng.choice(L, L // 3, replace=False)] = np.inf
    holes[7] = np.nan
    for j, (what, u) in enumerate((("distinct ubs", distinct),
                                   ("ubs of five values (ties)", five),
                                   ("a third inf, one NaN", holes))):
        ubs = torch.as_tensor(u, **f32)
        for K in (1, 4, 8, 12):
            got_rec, want_rec = (record(), record()) if j == 0 else (None,
                                                                     None)
            if got_rec is not None:
                for k_, v in got_rec.items():
                    want_rec[k_].copy_(v)
            got = pick.icp_seeds(ubs, R_lanes, nodes, K, reset=got_rec)
            want = pick.icp_seeds_plain(ubs, R_lanes, nodes, K,
                                        reset=want_rec)
            torch.cuda.synchronize()
            _require(same(got, want) and (got_rec is None or same(
                list(got_rec.values()), list(want_rec.values()))),
                f"icp_seeds == icp_seeds_plain bit for bit ({what}, K={K})")
            ks["errs"].append(err(got, want))
        print(f"icp_seeds syn07's {L} lanes, {what}: K=1, 4, 8, 12"
              f"{' (each resetting a 3-row record)' if j == 0 else ''}: "
              f"max_abs_err={max(ks['errs'][-4:]):.3g} (bit for bit)",
              flush=True)
    ubs = torch.as_tensor(distinct, **f32)
    K = cfg.icp_seeds
    out = tuple(torch.empty(s_, **f32) for s_ in ((K, 3, 3), (K, 3)))

    def kern_s():
        return pick.icp_seeds(ubs, R_lanes, nodes, K, out=out)

    def plain_s():
        return pick.icp_seeds_plain(ubs, R_lanes, nodes, K)
    ms, dms, pms = _median_ms(kern_s), _device_ms(kern_s), _median_ms(plain_s)
    t_ops = (L * L * SEEDS_PAIR_OPS + K * SEEDS_SEED_OPS) / PEAK_OPS
    t_bytes = (L * SEEDS_LANE_BYTES + K * SEEDS_SEED_BYTES) / PEAK_BYTES
    bms, bby = (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")
    launches, memsets = _launches_memsets(kern_s)
    _require(launches == 1 and memsets == 0,
             f"the seeds are one launch and no memset a call ({launches}, "
             f"{memsets})")
    # the selection alone (no gathers, no centres): one torch call
    def select():
        return torch.topk(ubs, K, largest=False)
    sel_ms, sel_dms = _median_ms(select), _device_ms(select)
    ks.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby, graph_ms=dms,
              library_ms=None, selection_ms=sel_ms,
              selection_graph_ms=sel_dms)
    print(f"icp_seeds timed: L={L} K={K}: kernel {ms:.4f} ms (from a graph "
          f"{dms:.4f} ms) plain {pms:.4f} ms bound {bms:.6f} ms ({bby}), "
          f"{launches:g} launch, {memsets:g} memsets a call; the selection "
          f"only, torch.topk(ubs, K, largest=False): {sel_ms:.4f} ms (from "
          f"a graph {sel_dms:.4f} ms); {floor}", flush=True)


# what the kernels line adds for the refine route: the three launches a
# row it replaced, timed the same two ways on the same inputs, and the
# two-row window's graph times (one launch against six)
REFINE_EXTRAS = ("three_launch_ms", "three_launch_graph_ms",
                 "icp_run_graph_ms", "window_graph_ms",
                 "window_three_graph_ms",
                 "trm00_graph_ms", "trm00_three_graph_ms",
                 "trm00_icp_run_graph_ms")


def _refine_bound(pair, c, K, L, iters, tensors):
    """(bound_ms, bound_by) of a refinement of one row: the seeds' ranks
    (SEEDS_PAIR_OPS a lane pair), the ICP's `iters` iterations (summed
    over the seeds; ICP_OPS an iteration, the trimmed modes' ranks ~2 Nd^2
    more), K rescorings and the candidate's count (SCORE_OPS a real
    point) over PEAK_OPS, against `tensors` read or written once and the
    rescorings' gathers over PEAK_BYTES."""
    nd, m = pair.n_data_padded, pair.model.shape[0]
    per_iter = ICP_OPS(nd, m) + (2 * nd * nd if c.doTrim else 0)
    real = _real_points(pair)
    t_ops = (L * L * SEEDS_PAIR_OPS + iters * per_iter
             + (K + 1) * real * SCORE_OPS) / PEAK_OPS
    t_bytes = (_nbytes(*tensors)
               + (K + 1) * real * SCORE_GATHER_BYTES) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _refine_checks(k, cases, cfg, cfg_t, pools, dev, floor):
    """Phase 2's check of the refine route (search/pick.py's icp_refine:
    csrc/icp.cu's goicp_icp_refine, every refining row of a transition in
    one launch: the seeds, the ICP event, the rescoring, the pick and the
    candidate's count) against the plain composition (refine_rows_plain:
    icp_seeds_plain, icp_run_plain, score_pick_plain) and the three
    launches a row it replaced (refine_rows_by_launches: icp_seeds,
    icp_run, score_pick), every field of a refine record bit for bit: on
    syn07's bucket, rows 0 and 2 of a 3-row record refining (row 1 the
    dummy), at K = 1, 4, 8 and 12 seeds of 16 lanes with distinct ubs,
    ubs of five values (ties) and a third inf with a NaN; with the ICP
    disabled; with the ICP's workspace in device memory; and on 2-row
    windows of two similar (both refining) and two trimmed bench pairs
    of one bucket (rows 0 and 2 of 3), each row its own pair.  Timed on
    one row whose lanes are the starts of _score_checks' syn07 4-seed
    event (its unpadded pair; icp_run's timing) and of trm00's dynamic
    trim (ubs ascending, nodes of width 0: the seeds are the event's bit
    for bit): single calls, from a CUDA graph, the plain composition, the
    three launches both ways, the event alone from a graph; the similar
    window from graphs (one launch against six).  One launch and no
    memset a call; ptxas's stack frame and spills of the refine route 0,
    printed beside the ICP route's registers."""
    import numpy as np
    import torch
    from goicp_tpu_torch import _build
    from goicp_tpu_torch.bench.icp_stops import kernel_info
    from goicp_tpu_torch.bench.measure import (_bucket_and_prepare,
                                               _normalized_synthetic)
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.icp.icp import icp_run
    from goicp_tpu_torch.search import device_engine as eng
    from goicp_tpu_torch.search import fused_stream as fs
    from goicp_tpu_torch.search import pick
    from goicp_tpu_torch.search.args import RefineRecord
    log = _build.build_info.get("log", "")
    for kname in ("icp_refine_kernel", "icp_init_kernel"):
        info = kernel_info(log, kname)
        _require(info and all("0 bytes stack frame, 0 bytes spill stores, "
                              "0 bytes spill loads" in x
                              for x in info if "stack frame" in x),
                 f"{kname} has no stack frame and no spills: {info}")
        print(f"{kname} (ptxas): {info}", flush=True)
    print(f"icp_run_kernel (ptxas): {kernel_info(log, 'icp_run_kernel')}",
          flush=True)
    f32 = dict(dtype=torch.float32, device=dev)
    rng = np.random.default_rng(21)

    def nodes_of(L):
        return torch.as_tensor(np.concatenate(
            [rng.uniform(-0.05, 0.05, (L, 3)),
             rng.uniform(0.01, 0.1, (L, 1))], axis=1), **f32)

    def lanes_of(pair, c, L=None):
        """A pair's first popped lanes (R_lanes, repeated to L), seeded
        best nodes and distinct ubs."""
        R = eng._pop(pair, c, eng.device_init(pair, c))["R_lanes"]
        L = R.shape[0] if L is None else L
        R = R.repeat(L // R.shape[0], 1, 1).contiguous()
        return R, nodes_of(L), torch.as_tensor(rng.uniform(0.5, 2.0, L),
                                               **f32)

    def row(j, pair, R, nodes, ubs):
        return (j, pair, R, nodes, ubs, R[j % R.shape[0]].contiguous(),
                nodes[j, :3] + nodes[j, 3] / 2.0)

    def check(label, c, todo, n, enabled=None):
        before = pick.icp_refine.launches
        got = pick.refine_rows(c, todo, n, dev, RefineRecord(), enabled)
        launched = pick.icp_refine.launches - before
        plain = pick.refine_rows_plain(c, todo, n, dev, RefineRecord(),
                                       enabled)
        three = pick.refine_rows_by_launches(c, todo, n, dev,
                                             RefineRecord(), enabled)
        torch.cuda.synchronize()
        g, p, t3 = (list(x.values()) for x in (got, plain, three))
        _require(launched == 1,
                 f"the refine route is one launch ({label}): {launched}")
        _require(_same_fields(g, p) and _same_fields(g, t3),
                 f"icp_refine == refine_rows_plain == the three launches "
                 f"bit for bit ({label}): {dict(got)} vs {dict(plain)} vs "
                 f"{dict(three)}")
        e = max(_field_err(g, p), _field_err(g, t3))
        k["errs"].append(e)
        return e

    syn07 = cases[1][1]
    R16, _, distinct = lanes_of(syn07, cfg, 16)
    five = torch.as_tensor(rng.integers(0, 5, 16).astype(np.float32), **f32)
    holes = distinct.clone()
    holes[::3] = float("inf")
    holes[7] = float("nan")
    done = []
    for what, u in (("distinct ubs", distinct), ("ubs of five values",
                                                  five),
                    ("a third inf, a NaN", holes)):
        for K in (1, 4, 8, 12):
            c = dataclasses.replace(cfg, icp_seeds=K)
            todo = [row(j, syn07, R16, nodes_of(16), u) for j in (0, 2)]
            done.append(check(f"syn07 {what}, K={K}", c, todo, 3))
    todo = [row(j, syn07, R16, nodes_of(16), distinct) for j in (0, 2)]
    done.append(check("syn07, the ICP disabled", cfg, todo, 3,
                      torch.tensor(False, device=dev)))
    smem = pick.ICP_SMEM_BYTES
    pick.ICP_SMEM_BYTES = 0            # every cloud's workspace on the card
    try:
        done.append(check("syn07, the ICP's workspace in device memory", cfg,
                          todo, 3))
    finally:
        pick.ICP_SMEM_BYTES = smem
    windows = {}
    for label, names, c, js, n in (
            ("similar window", ("syn02", "syn03"), cfg, (0, 1), 2),
            ("trimmed window", ("trm02", "trm03"), cfg_t, (0, 2), 3)):
        pb = stack_pairs(_bucket_and_prepare(
            [_normalized_synthetic(pools[x]) for x in names], c, device=dev))
        rows = [fs._pair_row(pb, r) for r in range(2)]
        todo = [row(j, p, *lanes_of(p, c)) for j, p in zip(js, rows)]
        done.append(check(f"{label} {'+'.join(names)}", c, todo, n))
        windows[label] = (c, todo, n)
    for label, pair, c in ((x[0], x[1], x[2]) for x in cases
                           if x[0].startswith("phase 11's")):
        done.append(check(f"{label} as one row", c,
                          [row(0, pair, *lanes_of(pair, c))], 1))
    print(f"icp_refine: syn07's bucket at K=1, 4, 8, 12 (16 lanes: "
          f"distinct, tied, inf and NaN ubs), the ICP disabled, its "
          f"workspace in device memory, a similar and a trimmed 2-row "
          f"window, phase 11's three options as one row: "
          f"max_abs_err={max(done):.3g} against the plain "
          f"composition and the three launches (bit for bit, every field "
          f"of the record, the rows that do not refine the dummy)",
          flush=True)

    # timed: one row whose lanes are an ICP event's starts (ubs ascending,
    # nodes of width 0: the route's seeds are the event's R0 and t0 bit
    # for bit), beside the event alone: syn07's 4 seeds on its unpadded
    # pair (icp_run's own timing) and trm00's dynamic trim; and the
    # similar window's two rows
    def as_row(case):
        _, pair, c, _, _, _, R0, t0 = case
        K = R0.shape[0]
        nodes = torch.cat([t0, torch.zeros_like(t0[:, :1])], 1).contiguous()
        todo = [(0, pair, R0.contiguous(), nodes, torch.arange(K, **f32),
                 R0[0].contiguous(), t0[0].contiguous())]
        return dataclasses.replace(c, icp_seeds=K), pair, todo

    def timed(case, plain_too=False):
        c, pair, todo = as_row(case)
        recs = [RefineRecord() for _ in range(3)]
        R0, t0 = case[6:8]

        def kern():
            return pick.refine_rows(c, todo, 1, dev, recs[0])

        def three():
            return pick.refine_rows_by_launches(c, todo, 1, dev, recs[1])

        def alone():
            return icp_run(pair.data, pair.model, R0, t0,
                           **pick.icp_kw(pair, c))
        got, want = kern(), three()
        torch.cuda.synchronize()
        _require(_same_fields(list(got.values()), list(want.values())),
                 f"icp_refine == the three launches bit for bit ({case[0]} "
                 f"as one row)")
        out = dict(ms=_median_ms(kern), graph_ms=_device_ms(kern),
                   three_ms=_median_ms(three),
                   three_graph_ms=_device_ms(three),
                   alone_graph_ms=_device_ms(alone),
                   iters=int(alone().iters.sum()), K=R0.shape[0])
        if plain_too:
            out["plain_ms"] = _median_ms(lambda: pick.refine_rows_plain(
                c, todo, 1, dev, recs[2]))
            out["launches"], out["memsets"] = _launches_memsets(kern)
            rec = recs[0].rows(1, dev)
            out["bound"] = _refine_bound(pair, c, out["K"], out["K"],
                                         out["iters"], [
                pair.data, pair.model, pair.weights, pair.data_mask,
                pair.data_props, pair.model_props, *todo[0][2:],
                *rec.values()])
        return out

    s7, tr = timed(cases[0], plain_too=True), timed(cases[2])
    _require(s7["launches"] == 1 and s7["memsets"] == 0,
             f"the refine route is one launch and no memset a call "
             f"({s7['launches']}, {s7['memsets']})")
    c, wtodo, n = windows["similar window"]
    wrecs = [RefineRecord() for _ in range(2)]

    def kern_w():
        return pick.refine_rows(c, wtodo, n, dev, wrecs[0])

    def three_w():
        return pick.refine_rows_by_launches(c, wtodo, n, dev, wrecs[1])
    wms, wms3 = _device_ms(kern_w), _device_ms(three_w)
    bms, bby = s7["bound"]
    k.update(ms=s7["ms"], plain_ms=s7["plain_ms"], bound_ms=bms,
             bound_by=bby, graph_ms=s7["graph_ms"], library_ms=None,
             three_launch_ms=s7["three_ms"],
             three_launch_graph_ms=s7["three_graph_ms"],
             icp_run_graph_ms=s7["alone_graph_ms"], window_graph_ms=wms,
             window_three_graph_ms=wms3, trm00_graph_ms=tr["graph_ms"],
             trm00_three_graph_ms=tr["three_graph_ms"],
             trm00_icp_run_graph_ms=tr["alone_graph_ms"])
    print(f"icp_refine timed on {cases[0][0]} as one row (K={s7['K']}, "
          f"{s7['iters']} ICP iterations over the seeds): kernel "
          f"{s7['ms']:.4f} ms (from a graph {s7['graph_ms']:.4f} ms) plain "
          f"{s7['plain_ms']:.4f} ms bound {bms:.6f} ms ({bby}), "
          f"{s7['launches']:g} launch, {s7['memsets']:g} memsets a call; the "
          f"three launches it replaced {s7['three_ms']:.4f} ms (from a graph "
          f"{s7['three_graph_ms']:.4f} ms); the ICP event alone from a graph "
          f"{s7['alone_graph_ms']:.4f} ms; {cases[2][0]} as one row (K="
          f"{tr['K']}) from a graph {tr['graph_ms']:.4f} ms, as three "
          f"launches {tr['three_graph_ms']:.4f} ms, the event alone "
          f"{tr['alone_graph_ms']:.4f} ms; the similar window's two rows "
          f"from a graph {wms:.4f} ms, as six launches {wms3:.4f} ms; "
          f"{floor}", flush=True)


# what the kernels line adds for the initial route: the two launches it
# replaced (icp_run, score_initial) timed the same two ways on the same
# pair, the event alone from a graph, and the engines' default of one
# seed from graphs, the route against the two launches
INIT_EXTRAS = ("two_launch_ms", "two_launch_graph_ms", "icp_run_graph_ms",
               "one_seed_graph_ms", "one_seed_two_graph_ms")


def _init_checks(k, cases, cfg, dev, floor):
    """Phase 2's check of the initial route (search/pick.py's
    initial_incumbent on the card: csrc/icp.cu's goicp_icp_init, an
    initial incumbent in one launch: the ICP events from init_seeds'
    starts, their rescoring, the initial error and the pick into the
    state's tensors) against the plain composition (initial_incumbent_
    plain: icp_run_plain, score_initial_plain) and the two launches it
    replaced (initial_incumbent_by_launches: icp_run, score_initial),
    every field bit for bit: at K = 1, 4 and 8 (every INIT_SEED_RV start)
    on syn07's unpadded pair and its padded bucket (data_mask, counts),
    trm00's dynamic trim and trm00 with a static trim (inlier_num < Nd);
    at K = 4 on phase 11's L1, c-FPFH and neighbour pairs and on syn07's
    bucket with the ICP's workspace in device memory (one block a row).
    Timed on syn07's bucket at 4 seeds (score_initial's timing) and at the
    engines' default of 1: single calls, from a CUDA graph, the plain
    composition (3 calls), the two launches both ways, the event alone
    from a graph.  One launch and no memset a call."""
    import torch
    from goicp_tpu_torch.icp.icp import icp_run
    from goicp_tpu_torch.search import pick
    keys = ("opt_err", "opt_R", "opt_t", "comp", "terms", "last_icp")

    def fields(d):
        return [d[x] for x in keys]

    def check(label, pair, c):
        before = pick.icp_init.launches
        got = pick.initial_incumbent(pair, c)
        launched = pick.icp_init.launches - before
        plain = pick.initial_incumbent_plain(pair, c)
        two = pick.initial_incumbent_by_launches(pair, c)
        torch.cuda.synchronize()
        g, p, t2 = fields(got), fields(plain), fields(two)
        _require(launched == 1,
                 f"the initial route is one launch ({label}): {launched}")
        _require(_same_fields(g, p) and _same_fields(g, t2),
                 f"the initial route == initial_incumbent_plain == the two "
                 f"launches bit for bit ({label}): {got} vs {plain} vs "
                 f"{two}")
        e = max(_field_err(g, p), _field_err(g, t2))
        k["errs"].append(e)
        return e

    done = []
    for i in range(4):
        label, pair, c = cases[i][:3]
        for K in (1, 4, len(pick.INIT_SEED_RV)):
            done.append(check(f"{label}, K={K}", pair,
                              dataclasses.replace(c, init_seeds=K)))
    for label, pair, c in ((x[0], x[1], x[2]) for x in cases
                           if x[0].startswith("phase 11's")):
        done.append(check(f"{label}, K=4", pair,
                          dataclasses.replace(c, init_seeds=4)))
    syn07, c4 = cases[1][1], dataclasses.replace(cases[1][2], init_seeds=4)
    smem = pick.ICP_SMEM_BYTES
    pick.ICP_SMEM_BYTES = 0            # every cloud's workspace on the card
    try:
        done.append(check("syn07's bucket, the ICP's workspace in device "
                          "memory, K=4", syn07, c4))
    finally:
        pick.ICP_SMEM_BYTES = smem
    print(f"icp_init: syn07 (unpadded, its bucket), trm00's dynamic trim "
          f"and its static trim at K=1, 4, {len(pick.INIT_SEED_RV)}; phase "
          f"11's three options and syn07's bucket with the workspace in "
          f"device memory at K=4: max_abs_err={max(done):.3g} against the "
          f"plain composition and the two launches (bit for bit, every "
          f"field of the incumbent)", flush=True)

    def timed(K, full=False):
        c = dataclasses.replace(cases[1][2], init_seeds=K)
        R0, t0 = pick.init_seeds(K, dev)

        def kern():
            return pick.initial_incumbent(syn07, c)

        def two():
            return pick.initial_incumbent_by_launches(syn07, c)

        def alone():
            return icp_run(syn07.data, syn07.model, R0, t0,
                           **pick.icp_kw(syn07, c))
        res = dict(graph_ms=_device_ms(kern), two_graph_ms=_device_ms(two))
        if full:
            res.update(ms=_median_ms(kern), two_ms=_median_ms(two),
                       alone_graph_ms=_device_ms(alone),
                       plain_ms=_median_ms(
                           lambda: pick.initial_incumbent_plain(syn07, c),
                           n=3),
                       iters=int(alone().iters.sum()))
            res["launches"], res["memsets"] = _launches_memsets(kern)
            real = _real_points(syn07)
            nd, m = syn07.n_data_padded, syn07.model.shape[0]
            t_ops = (res["iters"] * ICP_OPS(nd, m)
                     + (K + 1) * real * SCORE_OPS) / PEAK_OPS
            t_bytes = (_nbytes(syn07.data, syn07.model, syn07.weights,
                               syn07.data_mask, syn07.data_props,
                               syn07.model_props, R0, t0,
                               *kern().values())
                       + (K + 1) * real * SCORE_GATHER_BYTES) / PEAK_BYTES
            res["bound"] = (max(t_ops, t_bytes) * 1e3,
                            "operations" if t_ops >= t_bytes else "bytes")
        return res

    t4, t1 = timed(4, full=True), timed(1)
    _require(t4["launches"] == 1 and t4["memsets"] == 0,
             f"the initial route is one launch and no memset a call "
             f"({t4['launches']}, {t4['memsets']})")
    bms, bby = t4["bound"]
    k.update(ms=t4["ms"], plain_ms=t4["plain_ms"], bound_ms=bms,
             bound_by=bby, graph_ms=t4["graph_ms"], library_ms=None,
             two_launch_ms=t4["two_ms"],
             two_launch_graph_ms=t4["two_graph_ms"],
             icp_run_graph_ms=t4["alone_graph_ms"],
             one_seed_graph_ms=t1["graph_ms"],
             one_seed_two_graph_ms=t1["two_graph_ms"])
    print(f"icp_init timed on syn07's bucket, 4 seeds ({t4['iters']} ICP "
          f"iterations over the seeds): kernel {t4['ms']:.4f} ms (from a "
          f"graph {t4['graph_ms']:.4f} ms) plain {t4['plain_ms']:.4f} ms "
          f"bound {bms:.6f} ms ({bby}), {t4['launches']:g} launch, "
          f"{t4['memsets']:g} memsets a call; the two launches it replaced "
          f"{t4['two_ms']:.4f} ms (from a graph {t4['two_graph_ms']:.4f} "
          f"ms); the ICP event alone from a graph "
          f"{t4['alone_graph_ms']:.4f} ms; 1 seed from a graph "
          f"{t1['graph_ms']:.4f} ms, as two launches "
          f"{t1['two_graph_ms']:.4f} ms; {floor}", flush=True)


def _one_answer_phase(dev):
    """Phase 13: one answer on both devices (see the module docstring).
    The CPU's side of the bench pairs runs in a child process while this
    one computes the card's.  Returns the launch counts of syn72's
    registration."""
    import tempfile
    import torch
    from goicp_tpu_torch.bench import cpu_rows, launch_counts
    from goicp_tpu_torch.bounds import cuda_eval
    from goicp_tpu_torch.search.device_engine import register_device

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path, log = os.path.join(tmp, "cpu.pt"), os.path.join(tmp, "log")
        code = ("import sys, torch; from goicp_tpu_torch.bench import "
                "cpu_rows; torch.set_num_threads(6); "
                "cpu_rows.write_pair_results(sys.argv[1])")
        with open(log, "w") as fh:
            child = subprocess.Popen(
                [sys.executable, "-c", code, path], cwd=REPO,
                env=dict(os.environ, PYTHONPATH=REPO), stdout=fh,
                stderr=subprocess.STDOUT)
        try:
            card = {}
            for name in cpu_rows.BENCH_PAIRS:
                c, pg = cpu_rows.bench_pair(name, dev)
                card[name] = (cpu_rows.pair_digest(pg),
                              cpu_rows.pair_results(pg, c))
            t_card = time.perf_counter() - t_phase
            rc = child.wait(timeout=900)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        with open(log) as fh:
            tail = fh.read()[-2000:]
        _require(rc == 0, f"phase 13's CPU child exited {rc}: {tail}")
        cpu = torch.load(path, weights_only=False)   # written by the child
    n_checks, failed = 0, []
    for name, (digest, results) in card.items():
        cdigest, cresults = cpu[name]
        leaves = [k for k in digest if digest[k] != cdigest.get(k)]
        if leaves:
            failed.append((name, "prepare_pair", leaves))
        for label in results:
            diffs = cpu_rows.differences(results[label], cresults[label])
            if diffs:
                failed.append((name, label, diffs[:2]))
            n_checks += 1
    for name, label, diffs in failed:
        print(f"phase 13 {name} {label}: the card differs from the CPU: "
              f"{diffs}", flush=True)
    _require(not failed, f"phase 13: {len(failed)} of {n_checks} results "
             f"on the card == the CPU's bit for bit")
    t_pairs = time.perf_counter() - t_phase
    print(f"phase 13: {len(card)} bench pairs prepared on the card and on "
          f"the CPU (a child process, at the same time), the prepared "
          f"pairs and {n_checks // len(card)} results per pair equal bit "
          f"for bit ({n_checks} checks; card {t_card:.3f} s, both "
          f"{t_pairs:.3f} s)", flush=True)

    # the main path: syn72's registration against the port's CPU row
    want = cpu_rows.read_rows()["syn72"]
    c72, p72 = cpu_rows.bench_pair("syn72", dev)
    cuda_eval.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = register_device(p72, c72)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda_eval.launch_counts()
    got = cpu_rows.row_of(r)
    want_row = {k: v for k, v in want.items() if k != "pair"}

    def counters(row):
        return json.dumps({k: v for k, v in row.items() if k != "bits"})
    print(f"phase 13 syn72 register_device on the card: {wall:.3f} s | card "
          f"{counters(got)} | CPU row {counters(want_row)} | launches "
          f"{json.dumps(counts)}", flush=True)
    _require(got == want_row,
             f"phase 13 syn72 on the card == the port's CPU row in every "
             f"counter and bit: {got} vs {want}")
    for kname in PATH_KERNELS:
        _require(counts[kname] > 0, f"{kname} launched in phase 13")
    _step_path(counts, "phase 13")
    _pick_path(counts, "phase 13")
    _off_path(counts, "phase 13")
    _sums_in_prep(counts, "phase 13")

    # launches of the host-dispatched loops, after the path's counts
    loops = dict(global_iteration=launch_counts.global_iteration(),
                 icp_iteration=launch_counts.icp_iteration())
    for loop, v in loops.items():
        print(f"phase 13 launches per {loop.replace('_', ' ')}: "
              f"{v['launches']:.1f} ({v['ms']:.3f} ms on the host clock); "
              f"before the fixed order: "
              f"{BEFORE_FIXED_ORDER_LAUNCHES[loop]}, before the ICP kernel: "
              f"{BEFORE_ICP_KERNEL_LAUNCHES[loop]}", flush=True)
    one = launch_counts.one_pair_iteration()
    print(f"phase 13 launches per register_device inner iteration: "
          f"{one['launches']:.1f}, {one['host_reads']:.1f} host reads "
          f"({one['ms']:.3f} ms on the host clock)", flush=True)
    _require(loops["global_iteration"]["launches"] <= 8
             and one["launches"] <= 8 and one["host_reads"] == 1,
             f"a global iteration's inner step and a register_device inner "
             f"iteration are at most 8 launches (131 before the inner step "
             f"kernel), the latter with one host read: "
             f"{loops['global_iteration']}, {one}")
    v, rf = launch_counts.rescoring(), launch_counts.refine()
    print(f"phase 13 launches per rescoring: {v['launches']:.1f} "
          f"({v['ms']:.3f} ms on the host clock); before rotate, norm3 and "
          f"sincos32 were one launch each: "
          f"{BEFORE_FUSED_ORDER_LAUNCHES['rescoring']}; before the "
          f"rescoring was one launch: "
          f"{BEFORE_ONE_LAUNCH_RESCORING['rescoring']}", flush=True)
    ini = launch_counts.initial()
    rw = launch_counts.refine_window()
    print(f"phase 13 an improving step's refinement (the ICP seeds, the "
          f"event, the pick with its rescoring and the candidate's count, "
          f"written into the refine record): {rf['launches']:.1f} "
          f"launches, {rf['host_reads']:.1f} host reads, {rf['ms']:.3f} ms "
          f"on the host clock; before the refine route: "
          f"{BEFORE_REFINE_ROUTE['refine']}; before the pick was one "
          f"launch: {BEFORE_ONE_LAUNCH_PICK['refine']}; a fused-stream "
          f"window's two refining rows: {rw['launches']:.1f} launches, "
          f"{rw['host_reads']:.1f} host reads, {rw['ms']:.3f} ms (before: "
          f"{BEFORE_REFINE_ROUTE['refine_window']}); the initial incumbent: "
          f"{ini['launches']:.1f} launches, {ini['host_reads']:.1f} host "
          f"reads, {ini['ms']:.3f} ms; before: "
          f"{BEFORE_ONE_LAUNCH_PICK['initial']}", flush=True)
    _require(v["launches"] == 1, f"a rescoring is one launch: {v}")
    _require(rf["launches"] == 1 and rf["host_reads"] == 0
             and rw["launches"] == 1 and rw["host_reads"] == 0,
             f"an improving step's refinement, and a window's two refining "
             f"rows, is one launch of the refine route and no host read: "
             f"{rf}, {rw}")
    _require(ini["launches"] == 1 and ini["host_reads"] == 0,
             f"the initial incumbent is one launch (csrc/icp.cu's initial "
             f"route) and no host read: {ini}")
    tb, st = launch_counts.transition(), launch_counts.outer_step()
    print(f"phase 13 a fused-stream transition of {tb['rows']} rows: "
          f"{tb['launches']:.1f} launches, {tb['host_reads']:.1f} host "
          f"reads, {tb['syncs']:.1f} syncs, {tb['ms']:.3f} ms on the host "
          f"clock "
          f"({tb['launches_per_row']:.2f} launches and "
          f"{tb['ms_per_row']:.3f} ms a row); before the transition "
          f"kernel: {BEFORE_TRANSITION_KERNEL['transition']}; before "
          f"advance was one launch: "
          f"{BEFORE_ONE_LAUNCH_ADVANCE['transition']}", flush=True)
    print(f"phase 13 a register_device outer step: {st['launches']:.1f} "
          f"launches, {st['host_reads']:.1f} host reads, {st['syncs']:.1f} "
          f"syncs, {st['ms']:.3f} ms "
          f"on the host clock, {st['inner_iterations']} inner iterations "
          f"(besides them {st['launches_besides_inner']:.1f} launches, "
          f"{st['host_reads_besides_inner']:.1f} host reads; the inner "
          f"kernels' own {st['inner_launches']:.1f} launches); before the "
          f"transition kernel: {BEFORE_TRANSITION_KERNEL['outer_step']}; "
          f"before the inner run: {BEFORE_INNER_RUN['outer_step']}; "
          f"before advance was one launch: "
          f"{BEFORE_ONE_LAUNCH_ADVANCE['outer_step']}", flush=True)
    _require(st["inner_launches"] == 1 and st["launches"] <= 4,
             f"a register_device outer step is at most four launches (pop, "
             f"the inner run, harvest, adopt), its inner search one launch "
             f"of the inner run: {st}")
    _require(tb["launches"] <= 2 and tb["syncs"] <= 1,
             f"a stream transition batch is at most two launches (harvest, "
             f"advance) and one host read (a sync): {tb}")
    ev = launch_counts.icp_event()
    print(f"phase 13 an ICP event ({launch_counts.ICP_SEEDS} seeds, "
          f"iterations {ev['iterations']}): {ev['launches']:.1f} kernel "
          f"launches, {ev['host_reads']:.1f} host reads, "
          f"{ev['icp_run_launches']:.1f} launches of csrc/icp.cu, "
          f"{ev['ms']:.3f} ms on the host clock", flush=True)
    _require(ev["icp_run_launches"] == 1 and ev["host_reads"] == 0
             and loops["icp_iteration"]["launches"] == 0,
             f"an ICP event is one launch of csrc/icp.cu and no host read, "
             f"0 launches an iteration: {ev}, {loops['icp_iteration']}")
    rod, unc = launch_counts.rodrigues_call(), \
        launch_counts.rot_uncertainty_call()
    hs = launch_counts.host_outer_step()
    print(f"phase 13 a rodrigues of 8 centres: {rod['launches']:.1f} "
          f"launches ({rod['ms']:.4f} ms on the host clock); a "
          f"rot_uncertainty of 8 widths x {unc['points']} norms: "
          f"{unc['launches']:.1f} launches ({unc['ms']:.4f} ms); a "
          f"host-engine outer step ({hs['active']} lanes): "
          f"{hs['launches']:.1f} launches, {hs['host_reads']:.1f} host "
          f"reads, {hs['syncs']:.1f} syncs, {hs['ms']:.3f} ms on the host "
          f"clock; before rodrigues and rot_uncertainty were one launch "
          f"each: {BEFORE_ONE_LAUNCH_ROTATION}", flush=True)
    _require(rod["launches"] == 1 and unc["launches"] == 1,
             f"rodrigues and rot_uncertainty are one launch each: {rod}, "
             f"{unc}")
    print(f"phase 13 wall {time.perf_counter() - t_phase:.3f} s", flush=True)
    return counts


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import goicp_tpu_torch
    from goicp_tpu_torch import _build
    from goicp_tpu_torch.bench.measure import (_bucket_and_prepare,
                                               _normalized_synthetic,
                                               reference_rows, sweep_rows)
    from goicp_tpu_torch.bounds import cuda_eval
    from goicp_tpu_torch.bounds.evaluate import rot_uncertainty
    from goicp_tpu_torch.dist.mesh import stack_pairs
    from goicp_tpu_torch.geom.rotation import rodrigues_np
    from goicp_tpu_torch.pipeline.prepare import (make_count_dynamic,
                                                  prepare_pair)
    from goicp_tpu_torch.search import fused_stream
    from goicp_tpu_torch.search.device_engine import register_device
    from goicp_tpu_torch.search.fused_stream import register_fused_stream
    from goicp_tpu_torch.search.packed_stream import register_packed_stream

    # ---- 1. setup ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)          # the card's name and power limit
    _require(not torch.backends.cuda.matmul.allow_tf32
             and not torch.backends.cudnn.allow_tf32, "TF32 is off")
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"({_build.build_info['path']})", flush=True)
    for line in _build.build_info["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    floor_ms = _median_ms(lambda: cuda_eval.empty_launch(dev))
    floor_dev = _device_ms(lambda: cuda_eval.empty_launch(dev))
    floor = (f"launch floor {floor_ms:.4f} ms (from a graph "
             f"{floor_dev:.4f} ms)")
    print(f"an empty kernel: median of 25 single launches {floor_ms:.4f} ms "
          f"(the host's enqueue included); {floor_dev:.4f} ms a launch "
          f"replayed from a CUDA graph", flush=True)

    cfg, cfg_t, pools = _setup()

    # ---- 2. kernels vs plain at main-path shapes ----
    rng = np.random.default_rng(2026)
    kernels = {
        "geometric_bounds_kernel": dict(
            source="goicp_tpu_torch/csrc/geom_bounds.cu",
            replaces="goicp_tpu/bounds/pallas_eval.py:517", errs=[]),
        "chem_incomp_kernel": dict(
            source="goicp_tpu_torch/csrc/chem_incomp.cu",
            replaces="goicp_tpu/bounds/pallas_eval.py:702", errs=[]),
        "geometric_bounds_kernel_lanes": dict(
            source="goicp_tpu_torch/csrc/geom_bounds.cu",
            replaces="goicp_tpu/bounds/pallas_eval.py:632", errs=[]),
        "chem_incomp_kernel_lanes": dict(
            source="goicp_tpu_torch/csrc/chem_incomp.cu",
            replaces="goicp_tpu/bounds/pallas_eval.py:778", errs=[]),
        # not TPU kernels: the fixed-order sum and products of
        # utils/fp32.py
        "ordered_sum": dict(
            source="goicp_tpu_torch/csrc/ordered_sum.cu", replaces=None,
            errs=[]),
        **{name: dict(source=src, replaces=None, errs=[])
           for name, src in FUSED_ORDER.items()},
        **{name: dict(source="goicp_tpu_torch/csrc/fp32_products.cu",
                      replaces=None, errs=[])
           for name in FIXED_ORDER_PRODUCTS},
        # not TPU kernels: the ICP event and its Kabsch (icp/icp.py)
        **{name: dict(source="goicp_tpu_torch/csrc/icp.cu", replaces=None,
                      errs=[])
           for name in ("icp_run", "kabsch3", "icp_refine", "icp_init")},
        # not TPU kernels: the rescoring XLA computes (bounds/error.py),
        # the ICP seeds and the pick around the event (search/pick.py)
        **{name: dict(source="goicp_tpu_torch/csrc/score.cu",
                      replaces=None, errs=[])
           for name in ("score_kernel", "icp_seeds", "score_pick",
                        "score_initial")},
        # the whole inner-BnB iteration XLA runs around K3/K4 (the JAX
        # package's body), K1-K4's bodies inside it
        "inner_step": dict(source="goicp_tpu_torch/csrc/inner.cu",
                           replaces="goicp_tpu/search/inner.py:281",
                           errs=[]),
        # the loops around that iteration (the JAX package's
        # lax.while_loops of the inner search and of the fused stream)
        "inner_run": dict(source="goicp_tpu_torch/csrc/inner.cu",
                          replaces="goicp_tpu/search/inner.py:207",
                          errs=[]),
        # the outer-step transition XLA runs around the inner search (the
        # JAX package's _harvest and _advance, vmapped over the window)
        "harvest": dict(source="goicp_tpu_torch/csrc/transition.cu",
                        replaces="goicp_tpu/search/fused_stream.py:131",
                        errs=[]),
        "advance": dict(source="goicp_tpu_torch/csrc/transition.cu",
                        replaces="goicp_tpu/search/fused_stream.py:177",
                        errs=[]),
    }
    L, B = 8, cfg.trans_pop * 8
    k1 = kernels["geometric_bounds_kernel"]
    k3 = kernels["geometric_bounds_kernel_lanes"]
    k1["norm1"], k3["norm1"] = {}, {}
    for name, c in (("syn07", cfg), ("trm00", cfg_t)):
        pair = _prepared(name, c, pools, dev)
        _check_table(pair, name)
        nd = pair.n_data_padded
        rots = np.stack([rodrigues_np(v)
                         for v in rng.uniform(-2.5, 2.5, (L, 3))])
        pts = torch.as_tensor(
            np.einsum("lij,nj->lni", rots, pair.data.cpu().numpy()),
            dtype=torch.float32, device=dev).contiguous()
        centers = torch.as_tensor(rng.uniform(-0.5, 0.5, (L, B, 3)),
                                  dtype=torch.float32, device=dev)
        widths = torch.as_tensor(rng.uniform(0.03, 0.5, (L, B)),
                                 dtype=torch.float32, device=dev)
        unc = rot_uncertainty(torch.as_tensor(rng.uniform(0.05, 1.0, L),
                                              dtype=torch.float32,
                                              device=dev),
                              pair.norm_data).contiguous()
        g = pair.grid
        base = (pts, centers, widths)
        tabs = (pair.weights, g.cell_coords, g.nearest_cell, g.consts)
        if name == "syn07":
            cases = [("fused", unc, dict(fused=True)),
                     ("plain+unc", unc, {}),
                     ("plain", None, {})]
        else:
            k = pair.inlier_f()
            # the same pair with static counts: K is its inlier_num
            static = prepare_pair(*_normalized_synthetic(pools[name]), c,
                                  bucket=True, device=dev)
            _require(static.inlier_num < static.n_data
                     and not static.dynamic_counts, f"{name} with a static K")
            cases = [("fused K=counts[1]", unc,
                      dict(fused=True, trim_count=k)),
                     ("plain+unc K=counts[1]", unc, dict(trim_count=k)),
                     ("fused K static", unc,
                      dict(fused=True, trim_k=static.inlier_num))]
        # norm 2 (GoICPConfig's), then norm 1 (the fork's L1 option)
        for norm, (label, ru, extra) in itertools.product(
                (2, 1), cases):
            kw = dict(size=g.geom.size, norm=norm, **extra)

            def kern(args=(*base, ru, *tabs), kw=kw):
                return cuda_eval.geometric_bounds_kernel(*args, **kw)

            def plain(args=(*base, ru, *tabs), kw=kw):
                return cuda_eval.geometric_bounds_plain(*args, **kw)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            _require(_same_bits(got, want),
                     f"K1 == plain bit for bit ({name} {label}, norm {norm})")
            err = _max_err(got, want)
            k1["errs"].append(err)
            ms, pms, dms = _median_ms(kern), _median_ms(plain), _device_ms(kern)
            bms, bby = _bound(
                L * B * _real_points(pair),
                GEOM_OPS[norm, bool(extra.get("fused"))],
                [*base, ru, *tabs, extra.get("trim_count"), *got])
            times = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                         graph_ms=dms)
            if norm == 1:
                k1["norm1"][label] = dict(times, max_abs_err=err)
            elif label == "fused":
                k1.update(times)
            print(f"K1 {'norm 1 ' if norm == 1 else ''}{name} {label}: "
                  f"L={L} B={B} Nd={nd} C={g.cell_coords.shape[0]} "
                  f"max_abs_err={err:.3g} (bit for bit) kernel "
                  f"{ms:.4f} ms (from a graph {dms:.4f} ms) plain {pms:.4f} "
                  f"ms bound {bms:.6f} ms ({bby}) {floor}", flush=True)
        for q in (cfg.trans_pop * 19, 8):
            corners = torch.as_tensor(rng.uniform(-0.6, 0.6, (L, q, 3)),
                                      dtype=torch.float32, device=dev)
            cargs = (pts, corners, pair.cell_compat, pair.prop_onehot,
                     pair.data_mask, g.nearest_cell, g.consts)

            def kern2(cargs=cargs, size=g.geom.size):
                return cuda_eval.chem_incomp_kernel(*cargs, size=size)

            def plain2(cargs=cargs, size=g.geom.size):
                return cuda_eval.chem_incomp_plain(*cargs, size=size)
            got, want = kern2(), plain2()
            torch.cuda.synchronize()
            _require(torch.equal(got, want), f"K2 == plain ({name}, Q={q})")
            err = _max_err([got], [want])
            kernels["chem_incomp_kernel"]["errs"].append(err)
            ms, pms, dms = (_median_ms(kern2), _median_ms(plain2),
                            _device_ms(kern2))
            bms, bby = _bound(L * q * _real_points(pair), CHEM_OPS,
                              [*cargs, got])
            if name == "syn07" and q == cfg.trans_pop * 19:
                kernels["chem_incomp_kernel"].update(
                    ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                    graph_ms=dms)
            print(f"K2 {name} Q={q}: L={L} Nd={nd} "
                  f"C={g.cell_coords.shape[0]} max_abs_err={err:.3g} "
                  f"(exact) kernel {ms:.4f} ms (from a graph {dms:.4f} "
                  f"ms) plain {pms:.4f} ms bound {bms:.6f} ms ({bby}) "
                  f"{floor}", flush=True)

    # rows of more than 256 points (BO1 cavities reach 306): the trimmed
    # selection reads the row from the warp's shared-memory scratch
    # instead of its registers.  Static K in plain mode, dynamic K fused.
    data, model, dp, mp = _normalized_synthetic(pools["trm00"])
    long_pair = prepare_pair(data, model, dp, mp, cfg_t, bucket=True,
                             pad_data_to=320, device=dev)
    _require(long_pair.n_data_padded == 320
             and long_pair.inlier_num < long_pair.n_data, "a trimmed Nd=320")
    pts_long = torch.as_tensor(
        np.einsum("lij,nj->lni", rots, long_pair.data.cpu().numpy()),
        dtype=torch.float32, device=dev).contiguous()
    unc_long = rot_uncertainty(
        torch.as_tensor(rng.uniform(0.05, 1.0, L), dtype=torch.float32,
                        device=dev), long_pair.norm_data).contiguous()
    g = long_pair.grid
    for label, count, extra in (
            ("plain+unc K static", None,
             dict(trim_k=long_pair.inlier_num)),
            ("fused K=counts[1]", make_count_dynamic(long_pair).inlier_f(),
             dict(fused=True))):
        args = (pts_long, centers, widths, unc_long, long_pair.weights,
                g.cell_coords, g.nearest_cell, g.consts, count)
        kw_long = dict(size=g.geom.size, norm=cfg.norm, **extra)
        got = cuda_eval.geometric_bounds_kernel(*args, **kw_long)
        want = cuda_eval.geometric_bounds_plain(*args, **kw_long)
        _require(_same_bits(got, want),
                 f"K1 == plain bit for bit (trm00 {label}, Nd=320)")
        err = _max_err(got, want)
        k1["errs"].append(err)
        print(f"K1 trm00 {label}, Nd=320 (rows in shared memory): "
              f"max_abs_err={err:.3g} (bit for bit)", flush=True)

    # the tables in device memory: a 64^3 grid (1 MB of nearest cells) does
    # not fit a block's shared memory
    cfg64 = dataclasses.replace(cfg_t, distTransSize=64)
    pair64 = _prepared("trm00", cfg64, pools, dev)
    _check_table(pair64, "trm00 at S=64")
    g64 = pair64.grid
    _require(g64.nearest_cell.numel() * 4 > 227 * 1024, "S=64 table > 227 KB")
    pts64 = torch.as_tensor(
        np.einsum("lij,nj->lni", rots, pair64.data.cpu().numpy()),
        dtype=torch.float32, device=dev).contiguous()
    a64 = (pts64, centers, widths, unc, pair64.weights, g64.cell_coords,
           g64.nearest_cell, g64.consts, pair64.inlier_f())
    kw64 = dict(size=64, norm=cfg.norm, fused=True)
    got = cuda_eval.geometric_bounds_kernel(*a64, **kw64)
    want = cuda_eval.geometric_bounds_plain(*a64, **kw64)
    _require(_same_bits(got, want),
             "K1 == plain bit for bit with the tables in device memory "
             "(S=64)")
    k1["errs"].append(_max_err(got, want))
    corners64 = torch.as_tensor(
        np.random.default_rng(64).uniform(-0.6, 0.6,
                                          (L, cfg.trans_pop * 19, 3)),
        dtype=torch.float32, device=dev)
    c64 = (pts64, corners64, pair64.cell_compat, pair64.prop_onehot,
           pair64.data_mask, g64.nearest_cell, g64.consts)
    _require(torch.equal(cuda_eval.chem_incomp_kernel(*c64, size=64),
                         cuda_eval.chem_incomp_plain(*c64, size=64)),
             "K2 == plain with the table in device memory (S=64)")
    ms1 = _device_ms(lambda: cuda_eval.geometric_bounds_kernel(*a64, **kw64))
    ms2 = _device_ms(lambda: cuda_eval.chem_incomp_kernel(*c64, size=64))
    print(f"S=64, tables in device memory: K1 trm00 fused K=counts[1] "
          f"max_abs_err={_max_err(got, want):.3g} (bit for bit) "
          f"kernel {ms1:.4f} ms from a graph; K2 Q={corners64.shape[1]} "
          f"exact, kernel {ms2:.4f} ms from a graph", flush=True)

    # K1 at the host-streaming engine's shape: GoICPConfig's rot_batch 8
    # pops 8 rotation cubes an outer step, 8 children each: 64 lanes
    LH = goicp_tpu_torch.GoICPConfig().rot_batch * 8
    pair = _prepared("syn07", cfg, pools, dev)
    g = pair.grid
    rots_h = np.stack([rodrigues_np(v)
                       for v in rng.uniform(-2.5, 2.5, (LH, 3))])
    base_h = (torch.as_tensor(
                  np.einsum("lij,nj->lni", rots_h, pair.data.cpu().numpy()),
                  dtype=torch.float32, device=dev).contiguous(),
              torch.as_tensor(rng.uniform(-0.5, 0.5, (LH, B, 3)),
                              dtype=torch.float32, device=dev),
              torch.as_tensor(rng.uniform(0.03, 0.5, (LH, B)),
                              dtype=torch.float32, device=dev))
    unc_h = rot_uncertainty(torch.as_tensor(rng.uniform(0.05, 1.0, LH),
                                            dtype=torch.float32, device=dev),
                            pair.norm_data).contiguous()
    tabs_h = (pair.weights, g.cell_coords, g.nearest_cell, g.consts)
    host_shape = {}
    for label, ru, extra in (("fused", unc_h, dict(fused=True)),
                             ("plain+unc", unc_h, {}), ("plain", None, {})):
        def kern(args=(*base_h, ru, *tabs_h),
                 kw=dict(size=g.geom.size, norm=cfg.norm, **extra)):
            return cuda_eval.geometric_bounds_kernel(*args, **kw)

        def plain(args=(*base_h, ru, *tabs_h),
                  kw=dict(size=g.geom.size, norm=cfg.norm, **extra)):
            return cuda_eval.geometric_bounds_plain(*args, **kw)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        _require(_same_bits(got, want),
                 f"K1 == plain bit for bit (syn07 {label}, L={LH})")
        err = _max_err(got, want)
        k1["errs"].append(err)
        ms, pms, dms = _median_ms(kern), _median_ms(plain), _device_ms(kern)
        bms, bby = _bound(
            LH * B * _real_points(pair),
            GEOM_OPS[cfg.norm, bool(extra)],
            [*base_h, ru, *tabs_h, *got])
        host_shape[label] = dict(ms=ms, graph_ms=dms, plain_ms=pms,
                                 bound_ms=bms, bound_by=bby)
        print(f"K1 syn07 {label}, the host engine's shape: L={LH} B={B} "
              f"Nd={pair.n_data_padded} C={g.cell_coords.shape[0]} "
              f"max_abs_err={err:.3g} (bit for bit) kernel "
              f"{ms:.4f} ms (from a graph {dms:.4f} ms) plain {pms:.4f} ms "
              f"bound {bms:.6f} ms ({bby}) {floor}", flush=True)
    k1["host_shape"] = host_shape

    # K3 / K4 at the streams' shapes: two pairs of one bucket, 16 lanes
    # interleaved between them
    LS = 16
    lane_pair = torch.arange(LS, dtype=torch.int32, device=dev) % 2
    for names, c in ((("syn07", "syn13"), cfg), (("trm00", "trm01"), cfg_t)):
        two = _bucket_and_prepare(
            [_normalized_synthetic(pools[n]) for n in names], c, device=dev)
        for n, p in zip(names, two):
            _check_table(p, f"{n} (bucket of {'+'.join(names)})")
        st = stack_pairs(two)
        g = st.grid
        nd, size = st.n_data_padded, g.geom.size
        trimmed = c.doTrim
        rots = np.stack([rodrigues_np(v)
                         for v in rng.uniform(-2.5, 2.5, (LS, 3))])
        pts = torch.stack([
            torch.as_tensor(rots[l], dtype=torch.float32, device=dev)
            @ two[l % 2].data.T for l in range(LS)]
        ).transpose(1, 2).contiguous()
        centers = torch.as_tensor(rng.uniform(-0.5, 0.5, (LS, B, 3)),
                                  dtype=torch.float32, device=dev)
        widths = torch.as_tensor(rng.uniform(0.03, 0.5, (LS, B)),
                                 dtype=torch.float32, device=dev)
        rw = torch.as_tensor(rng.uniform(0.05, 1.0, LS),
                             dtype=torch.float32, device=dev)
        unc = torch.stack([rot_uncertainty(rw[l:l + 1],
                                           two[l % 2].norm_data)[0]
                           for l in range(LS)]).contiguous()
        kcount = st.counts[:, 1].contiguous() if trimmed else None
        a3 = (pts, centers, widths, unc, st.weights, g.cell_coords,
              g.nearest_cell, g.consts, kcount, lane_pair)
        n_real = sum(_real_points(two[l % 2]) for l in range(LS))
        label = "dynamic K" if trimmed else "untrimmed"
        for norm in (2, 1):
            def kern3(a3=a3, kw=dict(size=size, norm=norm)):
                return cuda_eval.geometric_bounds_kernel_lanes(*a3, **kw)

            def plain3(a3=a3, kw=dict(size=size, norm=norm)):
                return cuda_eval.geometric_bounds_lanes_plain(*a3, **kw)
            got, want = kern3(), plain3()
            torch.cuda.synchronize()
            _require(_same_bits(got, want),
                     f"K3 == plain bit for bit ({names}, {label}, norm "
                     f"{norm})")
            for l in range(LS):
                p = two[l % 2]
                one = cuda_eval.geometric_bounds_kernel(
                    pts[l:l + 1], centers[l:l + 1], widths[l:l + 1],
                    unc[l:l + 1], p.weights, p.grid.cell_coords,
                    p.grid.nearest_cell, p.grid.consts,
                    p.inlier_f() if trimmed else None, size=size,
                    norm=norm, fused=True)
                _require(all(torch.equal(a[l], b[0])
                             for a, b in zip(got, one)),
                         f"K3 == K1 at norm {norm} on lane {l} ({names}, "
                         f"{label})")
            err = _max_err(got, want)
            k3["errs"].append(err)
            ms, pms, dms = (_median_ms(kern3), _median_ms(plain3),
                            _device_ms(kern3))
            bms, bby = _bound(B * n_real, GEOM_OPS[norm, True], [*a3, *got])
            times = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                         graph_ms=dms)
            if norm == 1:
                k3["norm1"][label] = dict(times, max_abs_err=err)
            elif not trimmed:
                k3.update(times)
            print(f"K3 {'norm 1 ' if norm == 1 else ''}{'+'.join(names)} "
                  f"{label}: L={LS} B={B} Nd={nd} C={g.cell_coords.shape[1]} "
                  f"max_abs_err={err:.3g} (bit for bit; == K1 "
                  f"lane for lane) kernel {ms:.4f} ms (from a graph "
                  f"{dms:.4f} ms) plain {pms:.4f} ms bound {bms:.6f} ms "
                  f"({bby}) {floor}", flush=True)
        for q in (c.trans_pop * 19, 8):
            corners = torch.as_tensor(rng.uniform(-0.6, 0.6, (LS, q, 3)),
                                      dtype=torch.float32, device=dev)
            k4 = (pts, corners, st.cell_compat, st.prop_onehot,
                  st.data_mask, g.nearest_cell, g.consts, lane_pair)

            def kern4(k4=k4, size=size):
                return cuda_eval.chem_incomp_kernel_lanes(*k4, size=size)

            def plain4(k4=k4, size=size):
                return cuda_eval.chem_incomp_lanes_plain(*k4, size=size)
            got, want = kern4(), plain4()
            torch.cuda.synchronize()
            _require(torch.equal(got, want),
                     f"K4 == plain ({names}, Q={q})")
            for l in range(LS):
                p = two[l % 2]
                one = cuda_eval.chem_incomp_kernel(
                    pts[l:l + 1], corners[l:l + 1], p.cell_compat,
                    p.prop_onehot, p.data_mask, p.grid.nearest_cell,
                    p.grid.consts, size=size)
                _require(torch.equal(got[l], one[0]),
                         f"K4 == K2 on lane {l} ({names}, Q={q})")
            err = _max_err([got], [want])
            kernels["chem_incomp_kernel_lanes"]["errs"].append(err)
            ms, pms, dms = (_median_ms(kern4), _median_ms(plain4),
                            _device_ms(kern4))
            bms, bby = _bound(q * n_real, CHEM_OPS, [*k4, got])
            if not trimmed and q == c.trans_pop * 19:
                kernels["chem_incomp_kernel_lanes"].update(
                    ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                    graph_ms=dms)
            print(f"K4 {'+'.join(names)} Q={q}: L={LS} Nd={nd} "
                  f"C={g.cell_coords.shape[1]} max_abs_err={err:.3g} "
                  f"(exact; == K2 lane for lane) kernel {ms:.4f} ms "
                  f"(from a graph {dms:.4f} ms) plain {pms:.4f} ms bound "
                  f"{bms:.6f} ms ({bby}) {floor}", flush=True)

    _ordered_sum_checks(kernels["ordered_sum"], cfg, pools, dev, floor)
    _fused_checks(kernels, cfg, pools, dev, floor)
    _product_checks(kernels, cfg, pools, dev, floor)
    _icp_checks(kernels, cfg, cfg_t, pools, dev, floor)
    cases = _score_checks(kernels["score_kernel"], cfg, cfg_t, pools, dev,
                          floor)
    _pick_checks(kernels, cases, cfg, pools, dev, floor)
    _refine_checks(kernels["icp_refine"], cases, cfg, cfg_t, pools, dev,
                   floor)
    _init_checks(kernels["icp_init"], cases, cfg, dev, floor)
    _step_checks(kernels["inner_step"], cfg, cfg_t, pools, dev, floor)
    _run_checks(kernels["inner_run"], kernels, cfg, cfg_t, pools, dev, floor)
    _transition_checks(kernels, cfg, cfg_t, pools, dev, floor)

    if sys.argv[1:] == ["--kernels-only"]:
        print("kernels only: phases 3-13 not run, no result", flush=True)
        return 0
    _count_prep_sums()
    if sys.argv[1:] == ["--options"]:
        _options_phase(cfg, pools, dev)
        print("options only: phases 3-10 and 12 not run, no result",
              flush=True)
        return 0

    # ---- 3. registrations (the main path) ----
    ref = reference_rows()
    sweep = sweep_rows()
    cuda_eval.reset_launch_counts()
    phase3 = {}
    syn07 = None
    for name in SIMILAR + TRIMMED:
        c = cfg if name.startswith("syn") else cfg_t
        t0 = time.perf_counter()
        pair = _prepared(name, c, pools, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = register_device(pair, c)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _check_table(pair, name)
        got = dict(error=float(r.error), converged=bool(r.converged),
                   outer=int(r.outer_iters), inner=int(r.inner_iters),
                   evals=int(r.evals), icp_runs=int(r.icp_runs))
        phase3[name] = dict(got, opt_comp=int(r.opt_comp),
                            n_data=_real_points(pair))
        if name == "syn07":
            syn07 = (pair, r)
        want, row = ref[name], sweep[name]
        row_match = all(got[k] == row[k]
                        for k in ("outer", "inner", "evals", "icp_runs"))
        print(f"{name}: prepare {t1 - t0:.3f} s, register {t2 - t1:.3f} s | "
              f"port {json.dumps(got)} | fp32 reference "
              f"{json.dumps({k: want[k] for k in got})} | sweep row "
              f"{json.dumps({k: row[k] for k in got})} "
              f"counters_match_row={row_match}", flush=True)
        _require(got["converged"], f"{name} converged")
        _require(abs(got["error"] - want["error"]) <= ERR_TOL,
                 f"{name} error {got['error']} vs {want['error']}")
        if name.startswith("syn"):
            for k in ("outer", "inner", "evals", "icp_runs"):
                _require(got[k] == want[k] == row[k],
                         f"{name} {k}: port {got[k]}, reference {want[k]}, "
                         f"sweep row {row[k]}")
        else:
            _require(abs(got["evals"] - want["evals"])
                     <= TRIM_EVALS_REL * want["evals"],
                     f"{name} evals {got['evals']} vs {want['evals']}")
    counts = cuda_eval.launch_counts()

    # ---- 4. proof the main path ran the kernels ----
    print(f"launches during the registrations: {json.dumps(counts)}",
          flush=True)
    for kname in PATH_KERNELS + PREP_KERNELS:
        _require(counts[kname] > 0, f"{kname} launched on the main path")
    _step_path(counts, "phase 3")
    _pick_path(counts, "phase 3")
    _off_path(counts, "phase 3")
    _sums_in_prep(counts, "phase 3")
    counts3k = _knob_phase(cfg, *syn07)

    # ---- 5. and 6. the cross-pair streams ----
    stream_pools = []
    for label, names, c in (("similar", STREAM_SIMILAR, cfg),
                            ("trimmed", STREAM_TRIMMED, cfg_t)):
        t0 = time.perf_counter()
        pairs = _bucket_and_prepare(
            [_normalized_synthetic(pools[n]) for n in names], c, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        refs, walls = [], []
        for n, pair in zip(names, pairs):
            _check_table(pair, f"{n} ({label} pool's bucket)")
            torch.cuda.synchronize()
            tp = time.perf_counter()
            refs.append(register_device(pair, c))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - tp)
        print(f"{label} pool: {len(pairs)} pairs in one bucket (Nd="
              f"{pairs[0].n_data_padded}, C="
              f"{pairs[0].grid.cell_coords.shape[0]}), prepare "
              f"{t1 - t0:.3f} s; register_device one pair at a time "
              f"{sum(walls):.3f} s = {len(pairs) / sum(walls):.3f} pairs/s; "
              f"per pair s: "
              + " ".join(f"{n}={w:.3f}" for n, w in zip(names, walls)),
              flush=True)
        stream_pools.append((label, names, c, pairs, refs))

    stream_outs = {}

    def run_stream(phase, engine, fn):
        """Drive one stream over both pools with the launch counts at 0,
        hold every pair against register_device and its reference row,
        and return the launch counts of the phase."""
        cuda_eval.reset_launch_counts()
        for label, names, c, pairs, refs in stream_pools:
            fused_stream.reset_counters()
            before = cuda_eval.launch_counts()
            t0 = time.perf_counter()
            out = fn(pairs, c)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stream_outs[(phase, label)] = out
            sc = dict(fused_stream.counters)
            launched = {k: v - before[k]
                        for k, v in cuda_eval.launch_counts().items()}
            g = max(sc["global_iters"], 1)
            print(f"phase {phase} {engine} stream, {label} pool: wall "
                  f"{wall:.3f} s, {len(pairs) / wall:.3f} pairs/s, "
                  f"{sc['global_iters']} global iterations, "
                  f"{sc['transitions']} transition events, "
                  f"{sc['host_reads']} host reads = "
                  f"{sc['host_reads'] / g:.3f} per global iteration, "
                  f"launches {json.dumps(launched)} = "
                  + ", ".join(f"{k} {v / g:.3f}" for k, v in launched.items()
                              if v) + " per global iteration", flush=True)
            for i, (name, r) in enumerate(zip(names, refs)):
                got = dict(error=float(out.error[i]),
                           converged=bool(out.converged[i]),
                           outer=int(out.outer_iters[i]),
                           inner=int(out.inner_iters[i]),
                           evals=int(out.evals[i]),
                           icp_runs=int(out.icp_runs[i]),
                           opt_comp=int(out.opt_comp[i]))
                want = dict(error=float(r.error), converged=bool(r.converged),
                            outer=int(r.outer_iters),
                            inner=int(r.inner_iters), evals=int(r.evals),
                            icp_runs=int(r.icp_runs),
                            opt_comp=int(r.opt_comp))
                row = ref.get(name)
                row_match = None if row is None else all(
                    got[k] == row[k] for k in ("outer", "evals", "icp_runs"))
                print(f"  {name}: {engine} {json.dumps(got)} | "
                      f"register_device {json.dumps(want)} | "
                      f"counters_match_row={row_match}", flush=True)
                _require(got["converged"] and want["converged"],
                         f"{engine} {name} converged")
                _require(abs(got["error"] - want["error"]) <= STREAM_ERR_TOL,
                         f"{engine} {name} error {got['error']} vs "
                         f"register_device {want['error']}")
                if label == "similar":
                    for k in ("outer", "evals", "icp_runs", "opt_comp"):
                        _require(got[k] == want[k],
                                 f"{engine} {name} {k}: {got[k]} vs "
                                 f"register_device {want[k]}")
                else:
                    _require(abs(got["evals"] - want["evals"])
                             <= TRIM_EVALS_REL * want["evals"],
                             f"{engine} {name} evals {got['evals']} vs "
                             f"{want['evals']}")
                if row is not None:
                    _require(abs(got["error"] - row["error"]) <= ERR_TOL,
                             f"{engine} {name} error {got['error']} vs "
                             f"reference row {row['error']}")
        phase_counts = cuda_eval.launch_counts()
        print(f"launches during phase {phase}: {json.dumps(phase_counts)}",
              flush=True)
        for kname in PATH_KERNELS:
            _require(phase_counts[kname] > 0,
                     f"{kname} launched by the {engine} stream")
        _step_path(phase_counts, f"phase {phase} ({engine} stream)",
                   "inner_step" if engine == "packed" else "inner_run")
        _pick_path(phase_counts, f"phase {phase} ({engine} stream)")
        _off_path(phase_counts, f"phase {phase}")
        _sums_in_prep(phase_counts, f"phase {phase}")
        return phase_counts

    counts5 = run_stream(5, "fused", lambda pairs, c: register_fused_stream(
        pairs, c, width=2, chunk_steps=512))

    # phase 5's addition: the trimmed pool once more, every pair alive
    # after one chunk of 64 global iterations finished at twice the
    # translation frontier's capacity (after 2 chunks no trimmed pair is
    # still alive at width 2)
    _, names, c, pairs, _ = stream_pools[1]
    plain = stream_outs[(5, "trimmed")]
    cuda_eval.reset_launch_counts()
    fused_stream.reset_counters()
    t0 = time.perf_counter()
    esc = register_fused_stream(pairs, c, width=2, chunk_steps=64,
                                escalate_capacity=2 * c.trans_capacity,
                                escalate_after_chunks=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts5e = cuda_eval.launch_counts()
    _sums_in_prep(counts5e, "phase 5 (escalation)")
    n_esc = fused_stream.counters["escalated"]
    _require(n_esc > 0, "escalation sent a trimmed pair to the deferred "
             "phase")
    moved = []
    for i, (name, pair) in enumerate(zip(names, pairs)):
        eps = c.MSEThresh * _real_points(pair)
        _require(bool(esc.converged[i])
                 and abs(float(esc.error[i]) - float(plain.error[i]))
                 <= eps + STREAM_ERR_TOL,
                 f"escalated fused {name}: converged {esc.converged[i]}, "
                 f"error {esc.error[i]} vs the plain stream's "
                 f"{plain.error[i]} (eps {eps})")
        if int(esc.evals[i]) != int(plain.evals[i]):
            moved.append(name)
    print(f"phase 5 fused stream, trimmed pool, escalate_capacity="
          f"{2 * c.trans_capacity} after 1 chunk of 64: wall {wall:.3f} s; "
          f"{n_esc} pairs escalated; every pair converged, error within "
          f"MSEThresh*Nd + 1e-5 of the plain stream's; evals other than the "
          f"plain run's: {moved}; evals {int(np.sum(esc.evals))} (plain "
          f"{int(np.sum(plain.evals))}); launches {json.dumps(counts5e)}",
          flush=True)
    counts6 = run_stream(6, "packed", lambda pairs, c: register_packed_stream(
        pairs, dataclasses.replace(c, packed_slots=16, packed_trans_every=8),
        width=16, chunk_steps=512))

    counts7 = _entry_points(cfg, pools, ref, phase3, dev)
    counts8 = _bench_phase(dev)
    counts9, outs9 = _batch_phase(cfg, cfg_t, pools, ref, phase3, dev)
    counts10 = _multi_gpu_phase(cfg, syn07[1], phase3,
                                stream_outs[(5, "trimmed")], outs9["trimmed"])
    counts11 = _options_phase(cfg, pools, dev)
    counts12 = _sweep_phase(stream_outs, dev)
    counts13 = _one_answer_phase(dev)

    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"],
         "launches": sum(c.get(kname, 0)
                         for c in (counts, counts3k, counts5, counts5e,
                                   counts6, counts7, counts8, counts9,
                                   counts10, counts11, counts12, counts13)),
         "max_abs_err": max(k["errs"]), "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
         "launch_floor_ms": floor_ms, "graph_ms": k["graph_ms"],
         "graph_launch_floor_ms": floor_dev,
         **({"norm1": k["norm1"]} if "norm1" in k else {}),
         **({"sin_ms": k["sin_ms"]} if "sin_ms" in k else {}),
         # K1-K4's bodies also run inside every inner run and inner step
         # launch, K2's in every pop of the transition (the root corners)
         # too
         **({"body_runs_in": "inner_run, inner_step"} if kname in IN_STEP
            else {"body_runs_in": "inner_run, inner_step, advance"}
            if kname == "chem_incomp_kernel" else {}),
         **({k2: k[k2] for k2 in ("iterations", "steps_graph_ms")}
            if kname == "inner_run" else {}),
         **({k2: k[k2] for k2 in REFINE_EXTRAS} if kname == "icp_refine"
            else {}),
         **({k2: k[k2] for k2 in INIT_EXTRAS} if kname == "icp_init"
            else {}),
         **({k2: k[k2] for k2 in ("selection_ms", "selection_graph_ms")}
            if kname == "icp_seeds" else {})}
        for kname, k in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
