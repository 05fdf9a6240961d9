"""Drive the torch port's tri renderer and tet renderer, forward and
backward, their train steps on one process and on a 2-rank view mesh, the
example loops and the parity fuzz harnesses, on one CUDA card, check them,
and time the dispatch thresholds' ladder.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one) and nvcc. Steps:

1. print the card (name, count, nvidia-smi name and power limit);
2. build the CUDA kernels of dmesh_renderer_tpu_torch/csrc (one nvcc per
   source, all at once) and print the build time and ptxas usage, K1's,
   K3's, K4's, K5's, seg_sum's and T4's registers and shared memory on a
   line of their own;
3. hold the forward compositing kernel (K1, ``fwd_composite``) against its
   plain torch version on the card, at 4096 triangles, 256x256, B=2 and at
   the headline scene (100k triangles, 800x800, B=1, seed 0); time it
   (CUDA events, and its device time under the profiler), work out its
   bound from the run's counts, and count what its earlier shape (a block
   per 16x16 quarter, 256-slot rounds) and its current one (a block per
   32x32 tile, double-buffered 32-slot rounds, each lane walking only its
   pixel's covered slots) do with this run's data: the face rows each
   stages, and the blend's lane occupancy;
4. drive the serving path, ``TriRenderer`` on the card at the headline
   scene, with the launch counts set to 0 just before and read just after;
   check its outputs, time it (2 warm-up, 10 timed runs, CUDA events) and
   split the time by stage;
5. check the forward's edge cases on the card: no faces, no vertices, B=2
   at 800x800 with 20k triangles, and binned against the dense oracle at
   4096 triangles;
6. hold the backward kernel (K2, ``bwd_composite``) against its plain
   version with a fixed random upstream gradient, at 4096
   triangles/256x256/B=2 and at the headline: the compacted records (each
   tile's walked prefix, the first rows of the buffer that the slot
   capacity sizes) bit for bit and all the slot ids, and the five
   gradients bit for bit against plain's and against the reduce of the
   plain version's full [S, 4, 22] layout (every slot a row); time it,
   print the walked slots and (slot, quarter) pairs and the record bytes,
   and work out its bound from the run's counts;
7. hold ``seg_sum`` against its plain version bit for bit at both shapes
   the main path gives it (the headline's record reduce of the compacted
   records, its walked rows, and its vertex reduce), print their segment
   lengths (mean, p99,
   max), and time it at both beside its bound, ``torch.segment_reduce`` on
   rows already in CSR order and ``index_select`` + ``segment_reduce``
   from its own inputs;
8. drive the training path, ``TriRenderer`` on leaf tensors that require
   grad at the headline with the loss sum(color) + sum(depth), then
   ``backward()``, counts set to 0 just before and read just after; check
   the gradients, run it twice (bitwise equal), time it and split it;
9. binned against the oracle on the card, all five gradients at 4096
   triangles; zero gradients of empty geometry;
10. ``models.dmesh.make_train_step`` with Adam(1e-2, capturable=True) at
    the headline (zero target and background), 5 steps (the first eager,
    the second captured as a CUDA graph and replayed, three replays): the
    loss falls;
11. the B=2 scene (20k triangles, 800x800) with gradients;
12. hold the tet first-hit kernel (K3, ``first_hit``) and march kernel (K4,
    ``fwd_march``) against their plain versions at a small scene
    (``freudenthal_grid(6, 0.14, 21)``, 256x256, B=2, ray seed 17), at a
    ragged one (``freudenthal_grid(8, 0.1, 8)``, 100x72, B=2) and at
    the tet headline (``freudenthal_grid(20, 0.15, 2)``: 98,400 faces,
    48,000 tets, 800x800, B=1); time them (CUDA events, and their device
    times under the profiler) and work out their bounds from the run's
    counts; for K3 also count what its earlier shape (a block per 16x16
    quarter, 256-slot rounds) and its current one (a block per 32x32 tile,
    32-slot rounds, the next one staged while one is walked) do with this
    run's data: the rows each stages beside the slots needed, the rounds
    per tile, and the lane occupancy of their warps; then the card against
    the CPU on the ragged 100x72 and odd 37x50 scenes of
    ``tools.tet_stages`` (fault F4): the API's inverses
    (``ops.geometry.inverse44``) bit-equal on both devices, beside the
    solver's ``torch.linalg.inv``; every stage of the binned forward on
    shared inputs bit for bit (``tet_stages.card_vs_cpu``: only the march
    tables' log column and what K4 computes from it may differ); and the
    render with each device's own solver inverses and with the API's,
    whose colour and depth must hold 1e-5 with the mask and the saved
    integer state exact;
13. drive the tet serving path, ``TetRenderer`` on the card at the tet
    headline, counts set to 0 just before and read just after (K3 and K4
    once each); check the pair count (321,998, no overflow) and the
    first-hit pixels (577,342) exactly, and print the active pixels, the
    longest walk and the blend events beside the JAX package's CPU values,
    and the active pixels with the card's ``torch.linalg.inv`` and with
    LAPACK's in place of the API's inverses;
    time it (2 warm-up, 10 timed runs) and split it by stage;
14. the tet edge cases on the card: the dense first hit against the
    binned one, each forced, B=2 at the headline grid, jittered rays
    bit-equal to the CPU's, and the empty-geometry fill;
15. hold the tet backward march kernel (K5, ``bwd_march``) against its plain
    version with a fixed random upstream gradient, keys, records, mismatch
    flags and both gradients bit for bit, at the small tet scene and the
    tet headline, and ``seg_sum`` at the tet reduce's two shapes (record
    and vertex reduce; bit for bit, then timed alone as in step 7); print
    the re-walk mismatch count; time K5 and work out its bound from the
    run's counts;
16. drive the tet training path, ``TetRenderer`` on leaf ``verts_color``
    and ``faces_opacity`` at the tet headline with the loss sum(color) +
    sum(depth), then ``backward()``, counts set to 0 just before and read
    just after (K3, K4 and K5 once each, ``seg_sum`` twice); run it twice
    (bitwise equal), time it and split it; then time the tet forward
    without gradients again (no K5);
17. ``models.dmesh.make_tet_train_step`` with Adam(1e-2, capturable=True)
    at the tet headline (zero target and background), 5 steps (the first
    eager, the second captured as two CUDA graphs and replayed, three
    replays): the loss falls;
18. the tet backward's edge cases: the card's gradients against the port's
    on the CPU at the small tet scene, zero gradients of empty geometry,
    and B=2 at the headline grid with gradients;
19. drive the experiment tools' main path, every experiment of
    ``tools.exp_round3`` and ``tools.proto_march_kernel`` on the card,
    with the launch counts set to 0 just before and read just after (each
    of T1-T4 launched), and print each experiment's answers on one line;
    their timer (CUDA events, one warm-up call, the least of 3 rounds of
    the mean of 8 calls) gives T1-T4's times;
20. hold the experiment kernels against their plain versions on the card at
    full size, on the tools' inputs, bit for bit: T1 (``take_rows``) at 8
    and 5,000 rows of 128 lookups from tables of 8 to 48,000 rows, beside
    ``torch.gather``; T2 (``roll_merge``) on the [5000, 12, 128] buffer;
    T3's two entries (``mega_step``, ``two_table_step``) at 640,000 rays of
    the tet headline's tables, and against each other; T4 (``proto_step``)
    at 640,000 rays, step 1 and the 8-step chain on the tool's random
    tables, and step 1 and a 2-step chain on the tet headline's mesh, where
    rays advance; print the largest difference, each kernel's device time
    under the profiler (T4 also per step of the chain, beside the chain's
    per-step total, which holds the tool's torch glue), the plain
    versions' times with the tools' timer, and the bound from the run's
    counts (T1 also its 32-byte sector floor);
20b. split the host cost of one T1 call into its pieces (checks, output
    allocation, device, stream, pointers, the ctypes call), in us per call
    over 2,000 calls, for the call path before the lean one (rebuilt from
    its pieces) and for ``kernels.launch`` now, beside ``torch.gather``;
21. ``utils.diagnostics`` at the headlines: ``tri_render_stats`` (770,003
    pairs, no overflow) and ``tet_health`` (577,330 active pixels);
22. a ``diagnostics.trace`` of one tet and one tri training frame, each
    timed by a ``StageTimer``: the device busy share, the device time the
    trace holds over the frame's time;
23. multi-view training: the sharded train steps (``mesh=``) of both
    renderers on 2 ranks that share the card over gloo
    (``parallel.spawn``, after the parent built every kernel), at the tri
    headline at two views (``tri_scene(100_000, 2, 800, 800)``) and the tet
    headline at two views (``tet_scene(20, 2, 800, 800)``, ray seed 3): one
    SGD(1e-2) step against one process's B=2 step on the same batch (loss
    rtol 1e-6 tri, 2e-5 tet; parameters rtol 2e-5, atol 1e-7; gradients
    1e-4 rel), then two runs of 5 Adam(1e-2) steps: the loss falls, both
    ranks' parameters are bitwise equal after every step, the second run
    equals the first, and each rank launches K1 and K2 (tri), K3, K4 and K5
    (tet) once per step (counts set to 0 just before each step; ``seg_sum``'s
    count printed); the median ms of a sharded step (10 after 2 warm-ups)
    and of the all-reduce alone, beside one process's B=2 step;
24. checkpoint/resume at the tri (B=1) and tet headlines: 2 Adam steps,
    save, restore into a fresh state, 2 more, bitwise equal to 4
    uninterrupted steps (tri: capturable Adam, the steps captured);
25. both example loops on the card (``examples/port_optimize_*.py``, on 2
    ranks each): the loss falls, and the step resumed from the midpoint
    checkpoint equals the uninterrupted run's;
26. both parity fuzz harnesses on the card (``tools.fuzz_tri_parity``:
    the JAX sweep's 40 seeds from 1000 and 8 ``--big`` configs, K1, K2
    and ``seg_sum`` against the dense oracle; ``tools.fuzz_tet_parity``:
    30 seeds from 2000, each with the dense and the binned first hit
    against the f64 spec, evaluated in a process pool, and 6 ``--big``
    configs against the port on the CPU): any failure raises;
27. the dispatch ladder: the dense path against the binned one, medians
    of 10 synchronised calls after 2 warm-ups, forward and fwd+bwd; tri
    at 8 to 1,024 faces at 64x64, 256x256 and 800x800, tet on
    ``freudenthal_grid(2..8)`` at 256x256; the values the card's
    thresholds take from it (fwd+bwd at 256x256) beside those set;
28. the tri frame and train step as CUDA graphs at the tri headline and
    the tri small scene: 5 captured steps and a 5-step ``make_train_loop``
    bitwise equal to 5 eager steps (capturable Adam); a serving frame
    captured by ``torch.cuda.graph`` bitwise equal to the eager one; the
    launch counts of one capture (set to 0 just before) and the replays;
    then ``tools.tri_step_ms`` at the headline: eager and captured ms per
    serving frame and train step (medians of 20 synchronised calls after
    the warm-ups), ``make_train_loop`` ms per step at 20 steps, host syncs
    (eager at most 1, captured 0), device events, busy share, peak memory,
    and the binning's (key sort) and record CSR's device times;
29. the tet frame and train step as CUDA graphs at the tet headline and
    the tet small scene (ray seed 17): 5 captured steps (G1 zero_grad,
    forward and backward, the record flag read, G2 the optimiser step) and
    a 5-step ``make_tet_train_loop`` bitwise equal to 5 eager steps
    (capturable Adam), gradients too; a serving frame captured by
    ``torch.cuda.graph`` bitwise equal to the eager one; the launch counts
    of one capture (set to 0 just before: K3, K4, K5 once, ``seg_sum``
    twice) and the replays; at the small scene a record capacity of one
    record a ray, under which every replayed G1 flags the overflow and the
    step takes the exact fallback, bitwise the eager steps; then
    ``tools.tet_step_ms`` at the headline: eager and captured ms per
    serving frame and train step, ``make_tet_train_loop`` ms per step at
    20 steps, host syncs (eager at most 1, a captured frame 0, a captured
    step exactly 1), device events, busy share, peak memory, and the bbox
    emission's, record CSR's and record reduce's device times;
30. print one JSON line of per-kernel numbers, and as the last line
    ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result;
so does a rank that raises, dies or outlasts its time limit.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HEADLINE = dict(n_tris=100_000, n_views=1, height=800, width=800, seed=0)
SMALL = dict(n_tris=4096, n_views=2, height=256, width=256, seed=1)
TWO = dict(n_tris=20_000, n_views=2, height=800, width=800, seed=2)
# (face, tile) pairs the headline scene emits: a property of the scene and
# the exact-emission rule, the same count the JAX package's binning reports
# for it (BENCH_r04.json, roofline tri_emit_sort.events)
HEADLINE_PAIRS = 770_003
TOL = 1e-5  # K1 against plain: the same f32 ops in the same order
# K2 against plain, rel Linf of the records and of the five gradients: the
# same f32 ops in the same order, and the same sum order over the pixels
K2_RTOL = 1e-6
# binned against the dense oracle, five gradients, rel Linf: the binned
# path's tolerance against the oracle in the JAX package's tests
GRAD_RTOL = 1e-4
# Peaks of one H100 SXM at 700 W (NVIDIA data sheet): f32 outside the
# tensor cores and HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# f32/i32 operations of one (pixel, slot) visit of K1: the coverage test
# every visit does (3 edges x (2 mul + 2 add + 1 compare) + the nondeg
# test), and what a blended visit adds (ray/face intersection 28, clamp 4,
# interpolation 25, blend 12).
OPS_PER_VISIT = 16
OPS_PER_HIT = 69
# K2: a visit below the pixel's n_contrib tests coverage (16); an active
# visit does ~175 f32 operations (intersection 27, clamp 6, weights 2, T
# rebuild 3, interpolation 23, accumulators 16, dalpha and background 22,
# the weight and clamp chain 42, the moments 34); a live (slot, quarter)
# sums 20 values over 256 pixels (20 x 255 adds) and rebuilds dp (~60).
OPS_PER_BWD_ACTIVE = 175
OPS_PER_LIVE_SLOT = 20 * 255 + 60
FACE_ROW_BYTES = (27 + 9) * 4 + 4  # f32 + i32 face row, and its slot_face

# The tet scenes: (grid n, jitter, grid seed, views, H, W, ray seed); the
# headline is the JAX package's tet bench scene (bench.py, bench_tet_scaled)
TET_HEADLINE = dict(n_grid=20, n_views=1, height=800, width=800)
TET_SMALL = (6, 0.14, 21, 2, 256, 256, 17)
TET_DENSE = (5, 0.1, 8, 2, 256, 256, 0)  # 1,650 faces, both first hits forced
TET_RAGGED = (8, 0.1, 8, 2, 100, 72, 5)  # K3/K4 on an image of partial tiles
# the card against the CPU stage by stage (fault F4): scenes of
# dmesh_renderer_tpu_torch.tools.tet_stages.CASES
F4_CASES = ("ragged_100x72", "odd_37x50")
# Facts of the tet headline, not times: the (face, tile) pairs of its bbox
# emission at 32-px tiles (the JAX package's count), and the pixels with a
# first hit, which no transcendental enters, so the count is exact
TET_HEADLINE_PAIRS = 321_998
TET_HEADLINE_HIT_PIXELS = 577_342
# The JAX package's forward of the tet headline on the CPU (max_steps 512),
# printed beside the card's: active pixels, the longest walk, blend events
JAX_CPU_ACTIVE = 577_337
JAX_CPU_MAX_WALK = 17
JAX_CPU_BLENDS = 5_370_194
TET_TOL = 1e-6  # K3/K4 against plain: the same f32 ops in the same order
# f32 operations: a K3 (pixel, slot) visit (depth window 2, Moller-Trumbore
# 33, hit tests 6); a K4 blend (colour 21, weight 1, depth 9, log T 2, exp
# 1, accumulators 8, termination 2); a walk step that rebuilds the normals
# (T3, T4: 4 slots x (normal 27, Moller-Trumbore 51, selection 5)) and one
# that reads them from tet_nrm (K4, K5: 4 slots x (the normal's dot 5,
# Moller-Trumbore 51, selection 5))
OPS_PER_FH_VISIT = 41
OPS_PER_BLEND = 44
OPS_PER_WALK = 4 * (27 + 51 + 5)
OPS_PER_NRM_WALK = 4 * (5 + 51 + 5)
FH_ROW_BYTES = 16 * 4 + 4  # first-hit table row and its slot_face entry
# f32 operations of a K5 visit: barycentric 2, colour 18, depth 9, log T 1,
# exp 1, the four suffix accumulators 16, dL/dalpha 12 and its background
# term 7, the weight 2, the nine colour moments 12, termination 2
OPS_PER_BWD_VISIT = 82
# per ray with records, what K5 reads: ray 12, zw 16, start face/tet and
# first face 12, the 11 float rows 44, its slot offset 8; per ray its record
# count 4 and mismatch flag 1; per record the key 4 and 10 values 40
K5_RAY_BYTES = 12 + 16 + 12 + 44 + 8
K5_REC_BYTES = 4 + 10 * 4
# the card's tet gradients against the port's on the CPU, rel Linf: the two
# devices' exp and log differ in the last bits (hazard g)
TET_CARD_CPU_RTOL = 1e-5
# the tet render on the card against the CPU: colour and depth (the two
# devices' log and exp differ in the last bits)
TET_CARD_CPU_ATOL = 1e-5
# The experiment kernels' shapes (the JAX tools' full sizes): T1's table
# rows and lookup rows (8, the TPU's; 5,000 rows of 128, the march width),
# the rays of T2-T4 and T4's chained steps
PROBE_TABLE_ROWS = (8, 32, 64, 512, 48_000)
PROBE_LOOKUP_ROWS = (8, 5_000)
PROBE_RAYS = 640_000
# active pixels of the tet headline on the card and on the CPU, with the
# API's inverses (inverse44, bit-equal on both). A ray grazing an edge
# moves with the last bit of the inverse: 577,334 with the card's
# torch.linalg.inv, 577,329 with LAPACK's, 577,337 in the JAX package on
# the CPU (step 13 prints them)
TET_HEADLINE_ACTIVE = 577_330
# f32 operations per ray: T3 (shade select 4 x 12 multiply-adds, 4
# compares, colour 21, weight 1, the walk step, outputs 9) and T4 (the walk
# step, colour 21, weight 1, depth 6, log T 1, exp 1, compare 1,
# accumulators 8, counter 1)
OPS_T3_RAY = 48 + 4 + 21 + 1 + OPS_PER_WALK + 9
OPS_T4_RAY = OPS_PER_WALK + 21 + 1 + 6 + 1 + 1 + 1 + 8 + 1
# bytes per ray that the kernels read and write: T3 ct 4, consts rows 0-5,
# state rows 1-16, 17 rows out; T4 ct and cf 4 each, consts rows 0-9, state
# rows 0-10 and 12-15, 16 rows out
T3_RAY_BYTES = 4 + 6 * 4 + 16 * 4 + 17 * 4
T4_RAY_BYTES = 4 + 4 + 10 * 4 + 15 * 4 + 16 * 4
TRACE_DIR = Path(__file__).resolve().parent / ".traces"
# the dispatch ladder: dense against binned at these face counts and image
# sides (tri) and grids (tet, at LADDER_SIDE); medians of LADDER_TIMED
# after LADDER_WARMUP; the dense path is no longer timed after two points
# in a row at which it was LADDER_GIVE_UP times slower. The thresholds are
# read from fwd+bwd at LADDER_SIDE x LADDER_SIDE.
TRI_LADDER_FACES = (8, 16, 48, 128, 256, 512, 1024)
TRI_LADDER_SIZES = (64, 256, 800)
TET_LADDER_GRIDS = (2, 3, 4, 5, 6, 8)
LADDER_SIDE = 256
LADDER_WARMUP, LADDER_TIMED = 2, 10
LADDER_GIVE_UP = 4.0
# the fuzz sweeps: (first seed, configs) of the JAX harnesses' defaults,
# and the configs of their --big sweeps
FUZZ_TRI, FUZZ_TET = (1000, 40), (2000, 30)
FUZZ_BIG_TRI, FUZZ_BIG_TET = 8, 6
LAUNCH_CALLS = 2000  # calls per mean in the launch path's split
PROFILE_WINDOWS = 6  # profiler windows tried for a kernel's device time


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, warmup, reps):
    """Mean ms of ``fn()`` over ``reps`` runs, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel(got, want):
    """rel Linf: max |got - want| / max(1, max |want|)."""
    if want.numel() == 0:
        return 0.0
    return float((got.double() - want.double()).abs().max()
                 / max(1.0, float(want.abs().max())))


def seg_lengths(csr):
    """Segment lengths of a CSR: mean, p99, max and the empty count."""
    cnt = (csr.offsets[1:] - csr.offsets[:-1]).double()
    return {"n": cnt.numel(), "mean": float(cnt.mean()),
            "p99": float(torch.quantile(cnt, 0.99)), "max": int(cnt.max()),
            "empty": int((cnt == 0).sum())}


def time_seg_sum(x, csr, label):
    """seg_sum alone at one main-path shape (CUDA events over back-to-back
    calls, and the kernel's own time under the profiler; its plain
    version once), beside its bytes
    bound (each value, row id and offset read once, each sum written
    once), one ``torch.segment_reduce`` call on rows already in CSR order,
    and ``index_select`` + ``segment_reduce``, which start from the same
    inputs as seg_sum (the rows in segments: a static buffer's rows past
    them are left out, as seg_sum leaves them). Returns a dict of the
    numbers."""
    from dmesh_renderer_tpu_torch.ops import reduce as rd

    N, C = x.shape
    n_seg = csr.offsets.numel() - 1
    rows = int(csr.offsets[-1])  # the rows in segments: what seg_sum reads
    live = csr.order[:rows]
    data = x.index_select(0, live)
    lib = torch.segment_reduce(data, "sum", offsets=csr.offsets)
    check(rel(lib, rd.seg_sum(x, csr)) <= 1e-5,
          f"segment_reduce disagrees with seg_sum at the {label}")
    ms = cuda_ms(lambda: rd.seg_sum(x, csr), 2, 10)
    lib_ms = cuda_ms(
        lambda: torch.segment_reduce(data, "sum", offsets=csr.offsets), 2, 10)
    gather_ms = cuda_ms(lambda: torch.segment_reduce(
        x.index_select(0, live), "sum", offsets=csr.offsets), 2, 10)
    dev_ms = profiled_device_ms(lambda: rd.seg_sum(x, csr), "seg_sum")
    plain_ms = cuda_ms(lambda: rd.seg_sum_plain(x, csr), 0, 1)
    b_ms, b_by, _o, _b = bound(
        rows * C, rows * C * 4 + rows * csr.order.element_size()
        + csr.offsets.numel() * 8 + n_seg * C * 4)
    seg = seg_lengths(csr)
    log(f"seg_sum at the {label} ({N} x {C}, {rows} rows in segments -> "
        f"{n_seg} x {C}; segment "
        f"lengths mean {seg['mean']:.2f}, p99 {seg['p99']:.0f}, max "
        f"{seg['max']}, empty {seg['empty']}): {ms:.4f} ms (device "
        f"{dev_ms:.4f}; plain {plain_ms:.2f}); "
        f"torch.segment_reduce on the CSR-ordered rows {lib_ms:.4f} ms, "
        f"index_select + segment_reduce {gather_ms:.4f} ms; bound "
        f"{b_ms:.4f} ms by {b_by}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib_ms, "library_gather_ms": gather_ms,
            "shape": [N, C, n_seg], "rows": rows, "segments": seg}


def lane_occupancy(n):
    """The busy share of a kernel's lane-steps when lane i of each warp of
    32 takes ``n[i]`` steps and the warp runs as long as its longest lane."""
    pad = (-n.numel()) % 32
    w = torch.cat([n, n.new_zeros(pad)]).reshape(-1, 32)
    return float(n.sum()) / max(1.0, float(w.amax(1).sum()) * 32)


def ptxas_usage(logs, kernel):
    """ptxas's resource lines (registers, shared memory) of the kernels
    whose mangled names hold ``kernel``, from the build's -v output."""
    found = []
    for text in logs.values():
        lines = text.splitlines()
        for j, line in enumerate(lines):
            if "Compiling entry function" in line and kernel in line:
                for nxt in lines[j + 1:j + 6]:
                    if "registers" in nxt:
                        found.append(nxt.split(":", 1)[1].strip())
                        break
    return "; ".join(found) or "not reported"


def scene_tensors(n_tris, n_views, height, width, seed, dev):
    """Headline-style scene as CUDA tensors: (user inputs of TriRenderer,
    transposed functional args incl. inverses as the API takes them,
    bg)."""
    from dmesh_renderer_tpu_torch.utils.scenes import tri_scene

    v, f, vc, fo, mv, proj, vd, fi = tri_scene(n_tris, n_views, height,
                                               width, seed)
    from dmesh_renderer_tpu_torch.api import _inverses

    user = [torch.from_numpy(x).to(dev) for x in (v, f, vc, fo, mv, proj,
                                                  vd, fi)]
    mv_t = user[4].transpose(1, 2).contiguous()
    proj_t = user[5].transpose(1, 2).contiguous()
    bg = torch.tensor([0.1, 0.1, 0.1], device=dev)
    fargs = (user[0], user[1], user[2], user[3], mv_t, proj_t,
             *_inverses(mv_t, proj_t), user[6], user[7], bg)
    return user, fargs, bg


def stages(fargs, h, w, kcap=None):
    """The binned forward's stages, one function each (the sequence of
    ops.tri_binned.render_tri_binned), so that each can be timed."""
    from dmesh_renderer_tpu_torch.ops import binning, geometry, rays
    from dmesh_renderer_tpu_torch.ops import tri_binned as tb

    (verts, faces, vc, fo, mv_t, proj_t, inv_mv_t, inv_proj_t, vd, fi,
     bg) = fargs
    B = mv_t.shape[0]
    gx, gy = (w + 31) // 32, (h + 31) // 32
    kcap = binning.default_key_capacity(B, faces.shape[0]) \
        if kcap is None else kcap
    st = {}

    def project():
        ndc, img = geometry.project_verts(verts, mv_t, proj_t, w, h)
        st["img"] = img
        st["pre"] = geometry.preprocess_faces(ndc, img, faces, w, h, 32, 32)

    def binning_():
        st["keys"] = binning.emit_and_sort(st["pre"], gx, gy, kcap,
                                           tile_px=32)

    def face_table():
        ff, fi32 = tb.build_face_table(verts, faces, vc, fo, vd, fi,
                                       st["img"], inv_mv_t[:, 3, :3])
        k = st["keys"]
        st["ff"], st["fi"] = ff[k.sigma], fi32[k.sigma]

    def rays_():
        st["rd"] = rays.generate_rays(inv_mv_t, inv_proj_t, w, h)[1]

    def inputs():
        k = st["keys"]
        return (k.starts, k.ends, k.slot_face, st["ff"], st["fi"], st["rd"],
                B, h, w)

    def composite():
        C, D, T, _pT, _nc = tb.fwd_composite(*inputs())
        st["out"] = (C + T[:, None] * bg[None, :, None, None],
                     (D + T)[:, None])

    seq = [("projection+preprocess", project), ("binning", binning_),
           ("face table", face_table), ("rays", rays_), ("K1", composite)]
    return seq, st, inputs


def compare_kernel(inputs, label):
    """K1 against its plain version on the same CUDA inputs."""
    from dmesh_renderer_tpu_torch.ops import tri_binned as tb

    before = tb.fwd_composite.launches
    got = tb.fwd_composite(*inputs)
    torch.cuda.synchronize()
    check(tb.fwd_composite.launches == before + 1, "K1 did not launch")
    want = tb.fwd_composite_plain(*inputs)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, p in zip(("C", "D", "T", "prevT"), got, want):
        e = float((g - p).abs().max()) if g.numel() else 0.0
        check(np.isfinite(e) and e <= TOL, f"{label}: K1 {name} err {e}")
        err = max(err, e)
    check(torch.equal(got[4], want[4]), f"{label}: K1 n_contrib differs")
    log(f"K1 vs plain [{label}]: max_abs_err {err:.3g} (tol {TOL}), "
        f"n_contrib equal")
    return err, got


def _tile_planes(x, B, H, W, gx, gy, fill):
    """[B, H, W] -> [B*gy*gx, 1024]: each 32x32 tile's pixels, row-major
    (pixels past the image take ``fill``)."""
    pad = x.new_full((B, gy * 32, gx * 32), fill)
    pad[:, :H, :W] = x
    return pad.reshape(B, gy, 32, gx, 32).permute(0, 1, 3, 2, 4) \
        .reshape(B * gy * gx, 1024)


def _slot_chunks(inputs):
    """(slot slice, tile of each slot, pixel sample coords [n, 1024], the
    slot's covered mask [n, 1024], position in the tile list) per chunk of
    4096 slots."""
    from dmesh_renderer_tpu_torch.ops.geometry import edge_value

    starts, ends, slot_face, ff, fi, _rd, B, H, W = inputs
    gx, gy = (W + 31) // 32, (H + 31) // 32
    dev = starts.device
    yy, xx = torch.meshgrid(torch.arange(32, device=dev),
                            torch.arange(32, device=dev), indexing="ij")
    count = (ends - starts).long()
    S = int(ends[-1])  # the live slots, which come first
    tile_of_slot = torch.repeat_interleave(
        torch.arange(count.numel(), device=dev), count, output_size=S)
    pos = torch.arange(S, device=dev) - starts.long()[tile_of_slot]
    for s0 in range(0, S, 4096):
        sl = slice(s0, min(S, s0 + 4096))
        t = tile_of_slot[sl]
        ty, tx = (t % (gy * gx)) // gx, t % gx
        px = ((tx[:, None] * 32 + xx.reshape(1, -1)) * 16 + 8)
        py = ((ty[:, None] * 32 + yy.reshape(1, -1)) * 16 + 8)
        row = slot_face[sl].long()
        e = fi[row].long()
        cov = (ff[row, 26, None] > 0).expand(-1, 1024)
        for i in range(3):
            cov = cov & (edge_value(e[:, i, None], e[:, 3 + i, None],
                                    e[:, 6 + i, None], px, py) < 0)
        yield sl, t, cov, pos[sl]


def needed_work(inputs, got):
    """(visits, hits, shapes) of K1's run. visits and hits: per pixel, the
    slots of its tile up to the one that finished it (all of them if none
    did), and how many of those cover the pixel. shapes: the face rows
    that K1's earlier shape (a 256-thread block per 16x16 quarter,
    256-slot rounds) and its current one (a 1024-thread block per tile,
    32-slot rounds with the next one prefetched) stage in all, and the
    blend's lane occupancy (covered visits over 32 x the warp-steps of the
    blend) of three ways to walk: the earlier shape's 16x2-pixel warps,
    which step through every slot that a lane still walking covers; the
    current 8x4-pixel warps, each lane stepping only through its own
    covered slots of a round (the warp steps as often as its busiest
    lane); and the same warps with the round's covered pairs packed across
    lanes, 32 at a time (a variant that was built and measured slower:
    pairs past a pixel's exit in the round are packed too)."""
    from dmesh_renderer_tpu_torch.utils.config import T_EPS

    starts, ends, _sf, _ff, _fi, _rd, B, H, W = inputs
    _C, _D, T, _pT, nc = got
    gx, gy = (W + 31) // 32, (H + 31) // 32
    count = (ends - starts).long()
    inside = _tile_planes(torch.ones_like(T, dtype=torch.bool), B, H, W,
                          gx, gy, False)
    stop = torch.where(_tile_planes(T, B, H, W, gx, gy, 1.0) < T_EPS,
                       _tile_planes(nc.long(), B, H, W, gx, gy, 0),
                       count[:, None])
    stop = torch.where(inside, stop, 0)  # [NT, 1024]
    visits = int(stop.sum())
    # rows staged: a quarter block walks its rounds until its pixels are
    # done; a tile block also stages the round after its last
    q_rounds = (stop.reshape(-1, 2, 16, 2, 16).amax(dim=(2, 4)) + 255) // 256
    rows_quarter = int(torch.minimum(count[:, None, None], q_rounds * 256)
                       .sum())
    n_rounds = (count + 31) // 32
    staged = torch.minimum(n_rounds, (stop.amax(dim=1) + 31) // 32 + 1)
    rows_tile = int(torch.minimum(count, staged * 32).sum())
    # per (tile, round, pixel): its covered slots up to its exit, and the
    # covered slots of the pixels not done at the round's start
    first_round = torch.cumsum(n_rounds, 0) - n_rounds
    R = int(n_rounds.sum())
    own = torch.zeros((R, 1024), dtype=torch.int32, device=count.device)
    packed = torch.zeros((R, 1024), dtype=torch.int32, device=count.device)
    hits = quarter_steps = 0
    for _sl, t, cov, pos in _slot_chunks(inputs):
        act = cov & (pos[:, None] < stop[t])
        hits += int(act.sum())
        quarter_steps += int(act.reshape(-1, 2, 8, 2, 2, 16)
                             .any(dim=5).any(dim=3).sum())
        r = pos // 32
        own.index_add_(0, first_round[t] + r, act.int())
        packed.index_add_(0, first_round[t] + r,
                          (cov & (stop[t] > (r * 32)[:, None])).int())
    warps = lambda x: x.reshape(R, 8, 4, 4, 8).permute(0, 1, 3, 2, 4) \
        .reshape(R, 32, 32)  # [round, 8x4-pixel warp, lane]
    own_steps = int(warps(own).amax(dim=2).sum())
    packed_steps = int(((warps(packed).sum(dim=2) + 31) // 32).sum())
    steps = {"quarter_blocks_16x2_warps": quarter_steps,
             "tile_blocks_own_covered_slots": own_steps,
             "tile_blocks_packed_across_lanes": packed_steps}
    shapes = {
        "rows_staged": {"quarter_blocks_256_slot_rounds": rows_quarter,
                        "tile_blocks_32_slot_rounds": rows_tile},
        "blend_lane_occupancy": {k: hits / max(1, 32 * v)
                                 for k, v in steps.items()},
        "blend_warp_steps": steps,
    }
    return visits, hits, shapes


def bwd_work(inputs, nc):
    """What K2's run needs: (visits, active visits, live (slot, quarter)
    pairs, face rows, walked (slot, quarter) pairs). A pixel tests coverage
    at every slot below its n_contrib; an active visit is a covered one (a
    ray parallel to its face, which the kernel also drops, is not
    subtracted); a (slot, quarter) is live when any of its pixels is
    active; a tile walks (and needs the rows of) its slots below its
    largest n_contrib, a quarter those below its own largest."""
    starts, ends, _sf, _ff, _fi, _rd, B, H, W = inputs
    gx, gy = (W + 31) // 32, (H + 31) // 32
    ncp = _tile_planes(nc.long(), B, H, W, gx, gy, 0)  # [NT, 1024]
    count = (ends - starts).long()
    visits = int(nc.long().sum())
    rows = int(torch.minimum(count, ncp.max(dim=1).values).sum())
    quarter_max = ncp.reshape(-1, 2, 16, 2, 16).amax(dim=(2, 4))
    pairs = int(torch.minimum(count[:, None, None], quarter_max).sum())
    active = live = 0
    for _sl, t, cov, pos in _slot_chunks(inputs):
        act = cov & (pos[:, None] < ncp[t])
        active += int(act.sum())
        live += int(act.reshape(-1, 2, 16, 2, 16).any(dim=(2, 4)).sum())
    return visits, active, live, rows, pairs


def bound(ops, nbytes):
    ops_ms, bytes_ms = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes"), ops_ms, bytes_ms


def _full_walk(starts, ends, _n_contrib, _B, _H, _W):
    """``walked_slots`` with every slot walked: the tile ranges cover the
    slots in order, so the plain version puts each record at its own slot,
    the full [S, 4, 22] layout that K2 wrote before the compaction."""
    check(int(starts[0]) == 0 and torch.equal(starts[1:], ends[:-1]),
          "tile ranges do not cover the slots in order")
    return torch.cat([starts, ends[-1:]]), ends[-1]


def full_layout_plain(inputs, state, gin):
    """The plain version's records in the full layout (one row per slot,
    zeros past each tile's walk) and their slot ids, arange(S)."""
    from dmesh_renderer_tpu_torch.ops import tri_binned as tb

    walked_slots = tb.walked_slots
    tb.walked_slots = _full_walk
    try:
        return tb.bwd_composite_plain(*inputs[:6], *state, gin, *inputs[6:])
    finally:
        tb.walked_slots = walked_slots


def compare_k2(inputs, k1_out, faces, faces_intense, n_verts, sigma, label,
               seed):
    """K2 against its plain version on the same CUDA inputs and a fixed
    random upstream gradient: the compacted records (the first Wk rows of
    the buffer the slot capacity sizes; K2 leaves the rest unwritten) and
    every slot id bit for bit; then the five gradients reduced from each,
    and from the plain version's full layout (every live slot a row), bit
    for bit. Returns (max abs err, (records, slot ids), gin, Wk)."""
    from dmesh_renderer_tpu_torch.ops import tri_binned as tb

    B, H, W = inputs[6:]
    g = torch.Generator().manual_seed(seed)
    gin = torch.randn((B, 5, H, W), generator=g).to(inputs[5].device)
    state = k1_out[2:]
    # free NaN-filled blocks of the output's sizes, which the caching
    # allocator hands to the call: a row K2 does not write then shows
    _offs, total = tb.walked_slots(inputs[0], inputs[1], state[2], B, H, W)
    total = int(total)
    S = inputs[2].numel()
    for n in (S * 4 * tb.REC_COLS, S):
        torch.full((n,), float("nan"), device=gin.device)
    before = tb.bwd_composite.launches
    rec, ids = tb.bwd_composite(*inputs[:6], *state, gin, B, H, W)
    torch.cuda.synchronize()
    check(tb.bwd_composite.launches == before + 1, "K2 did not launch")
    want, want_ids = tb.bwd_composite_plain(*inputs[:6], *state, gin, B, H, W)
    torch.cuda.synchronize()
    check(bool((want != 0).any()), f"{label}: K2 records all zero")
    check(rec.shape == want.shape == (S, 4, tb.REC_COLS)
          and torch.equal(ids, want_ids),
          f"{label}: K2's compacted rows or slot ids differ from plain")
    check(bool((ids[total:] == S).all()),
          f"{label}: a row past the walked total has no sentinel slot id")
    e_rec = rel(rec[:total], want[:total])
    check(np.isfinite(e_rec) and e_rec <= K2_RTOL,
          f"{label}: K2 records rel err {e_rec}")
    check(torch.equal(rec[:total], want[:total]),
          f"{label}: K2 records differ from plain (rel err {e_rec})")
    args = (inputs[2], sigma, inputs[3], faces, faces_intense, n_verts)
    gk = tb.reduce_records(rec, ids, *args)
    gp = tb.reduce_records(want, want_ids, *args)
    e_grad = max(rel(a, b) for a, b in zip(gk, gp))
    check(all(torch.equal(a, b) for a, b in zip(gk, gp)),
          f"{label}: K2 gradients differ from plain's (rel {e_grad})")
    full, all_ids = full_layout_plain(inputs, state, gin)
    check(full.shape[0] == S
          and torch.equal(full[ids[:total].long()], rec[:total]),
          f"{label}: the full layout's walked rows differ from K2's")
    gf = tb.reduce_records(full, all_ids, *args)
    check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
              for a, b in zip(gk, gf)),
          f"{label}: K2's gradients differ from the full layout's reduce")
    log(f"K2 vs plain [{label}]: {total} walked slots of "
        f"{int(inputs[1][-1])} live ({total * 4 * tb.REC_COLS * 4} record "
        f"bytes written, in a buffer of {S} rows), records and slot ids "
        f"bitwise equal; the five gradients bitwise equal to plain's and to "
        f"the reduce of the full layout")
    return max(float((rec[:total] - want[:total]).abs().max()), max(
        float((a - b).abs().max()) for a, b in zip(gk, gp))), (rec, ids), \
        gin, total


def leaves_of(user):
    """Fresh leaf copies of the five differentiable user inputs."""
    return [user[i].detach().clone().requires_grad_(True)
            for i in (0, 2, 3, 6, 7)]


def tet_user(n_grid, n_views, jitter, gseed, dev, seed_offset=0):
    """A tet scene as CUDA tensors: (user inputs of TetRenderer, the
    functional args with transposed matrices and inverses, bg)."""
    from dmesh_renderer_tpu_torch.api import _inverses
    from dmesh_renderer_tpu_torch.utils import connectivity, scenes

    if (jitter, gseed) == (0.15, 2):
        arrs = scenes.tet_scene(n_grid, n_views, 0, 0)
    else:
        v, tets = connectivity.freudenthal_grid(n_grid, jitter, gseed)
        f, ft, tf = connectivity.build_tet_connectivity(tets)
        rng = np.random.RandomState(33 + seed_offset)
        vc = rng.rand(v.shape[0], 3).astype(np.float32)
        fo = rng.uniform(0.05, 0.95, f.shape[0]).astype(np.float32)
        fo[rng.randint(0, f.shape[0], f.shape[0] // 10)] = 1.0
        fi = rng.uniform(0.5, 1.0, (n_views, f.shape[0])).astype(np.float32)
        mv, proj = scenes.ring_cameras(n_views)
        arrs = (v, f, vc, fo, mv, proj,
                np.zeros((n_views, v.shape[0]), np.float32), fi, tets, ft, tf,
                np.array([0.1, 0.2, 0.3], np.float32))
    user = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in arrs[:11]]
    bg = torch.from_numpy(arrs[11]).to(dev)
    mv_t = user[4].transpose(1, 2).contiguous()
    proj_t = user[5].transpose(1, 2).contiguous()
    fargs = (user[0], user[1], user[2], user[3], mv_t, proj_t,
             *_inverses(mv_t, proj_t), user[7],
             user[8], user[9], user[10], bg)
    return user, fargs, bg


def compare_tet_kernels(fh_inputs, march_inputs, label):
    """K3 and K4 against their plain versions on the same CUDA inputs.
    Returns (max abs error, K3's output, the plain K3's per-pixel visits,
    K4's output, whether each kernel was bit-equal)."""
    from dmesh_renderer_tpu_torch.ops import tet as pt
    from dmesh_renderer_tpu_torch.ops import tet_first_hit as pfh

    b3, b4 = pfh.first_hit.launches, pt.fwd_march.launches
    g3 = pfh.first_hit(*fh_inputs)
    torch.cuda.synchronize()
    check(pfh.first_hit.launches == b3 + 1, "K3 did not launch")
    *p3, visits = pfh.first_hit_plain(*fh_inputs, with_visits=True)
    check(torch.equal(g3[0], p3[0]), f"{label}: K3 first_face differs")
    check(torch.equal(g3[4], p3[4]), f"{label}: K3 walked differs")
    err3 = max(float((a - b).abs().max()) for a, b in zip(g3[1:4], p3[1:4]))
    check(np.isfinite(err3) and err3 <= TET_TOL, f"{label}: K3 tuv {err3}")
    eq3 = all(torch.equal(a, b) for a, b in zip(g3, p3))
    g4 = pt.fwd_march(*march_inputs)
    torch.cuda.synchronize()
    check(pt.fwd_march.launches == b4 + 1, "K4 did not launch")
    p4 = pt.fwd_march_plain(*march_inputs)
    check(torch.equal(g4[1], p4[1]),
          f"{label}: K4 last face/last tet/n_contrib/active differ")
    err4 = float((g4[0] - p4[0]).abs().max())
    check(np.isfinite(err4) and err4 <= TET_TOL, f"{label}: K4 err {err4}")
    eq4 = torch.equal(g4[0], p4[0])
    log(f"K3 vs plain [{label}]: first_face, walked equal; t/u/v max_abs_err "
        f"{err3:.3g} (tol {TET_TOL}); bit-equal {eq3}")
    log(f"K4 vs plain [{label}]: last face, last tet, n_contrib, active "
        f"equal; C/D/logT max_abs_err {err4:.3g} (tol {TET_TOL}); bit-equal "
        f"{eq4}")
    return max(err3, err4), g3, visits, g4, (eq3, eq4)


def k3_shapes(fh_inputs, walked, visits):
    """What K3's shapes do with this run's data, from the plain version's
    per-pixel visits (the faces a pixel hit-tested; one that tested fewer
    than its list holds stopped at the next slot, and steps once more to
    read it): the rows that the earlier shape (a 256-thread block per 16x16
    quarter of a tile, 256-slot rounds) staged, counted as its plain
    version counted them, and that the current one (a block per tile,
    32-slot rounds, the next one staged while one is walked) staged, which
    is K3's ``walked``; the current shape's rounds per tile; and the lane
    occupancy, the tests over the test slots of the warps' steps (a warp
    steps as long as its slowest pixel, and offers one test per pixel per
    step), of the earlier 16x2-pixel warps, of 8x4-pixel warps with one
    pixel a lane, and of the current 16x8-pixel warps with four."""
    starts, ends, _sf, _tab, _rd, B, H, W = fh_inputs
    gx, gy = (W + 31) // 32, (H + 31) // 32
    never = 1 << 40
    count = (ends - starts).long()
    inside = _tile_planes(torch.ones_like(visits, dtype=torch.bool), B, H, W,
                          gx, gy, False)
    v = _tile_planes(visits, B, H, W, gx, gy, 0)  # [NT, 1024]
    cnt = count[:, None].expand_as(v)
    stopped = inside & (v < cnt)
    steps = torch.where(stopped, v + 1, torch.where(inside, cnt, 0))
    done_at = torch.where(stopped, v, torch.where(inside, never, -1))
    q_last = done_at.reshape(-1, 2, 16, 2, 16).amax(dim=(2, 4))
    q_rounds = torch.clamp(q_last, max=never - 1) // 256 + 1
    rows_quarter = int(torch.minimum(count[:, None, None], q_rounds * 256)
                       .sum())
    n_rounds = (count + 31) // 32
    walked_rounds = torch.minimum(
        n_rounds, torch.clamp(done_at.amax(dim=1), max=never - 1) // 32 + 1)
    staged = torch.minimum(n_rounds, walked_rounds + 1)
    check(torch.equal(torch.minimum(count, staged * 32),
                      walked.reshape(-1).long()),
          "K3's walked disagrees with the rounds its pixels need")
    tests = int(v.sum())
    occ, warp_steps = {}, {}
    for name, pw, ph in (("quarter_blocks_16x2_warps", 16, 2),
                         ("tile_blocks_8x4_warps_1_pixel_a_lane", 8, 4),
                         ("tile_blocks_16x8_warps_4_pixels_a_lane", 16, 8)):
        ws = int(steps.reshape(-1, 32 // ph, ph, 32 // pw, pw)
                 .amax(dim=(2, 4)).sum())
        warp_steps[name] = ws
        occ[name] = tests / max(1, pw * ph * ws)
    f = lambda x: {"mean": float(x.double().mean()), "max": int(x.max())}
    return {
        "rows_staged": {"quarter_blocks_256_slot_rounds": rows_quarter,
                        "tile_blocks_32_slot_rounds": int(walked.sum())},
        "rounds_per_tile": {"in_list": f(n_rounds), "walked": f(walked_rounds),
                            "staged": f(staged)},
        "lane_occupancy": occ, "warp_steps": warp_steps, "tests": tests,
    }


def tet_card_vs_cpu(dev, case):
    """Fault F4: a scene of ``tools.tet_stages.CASES`` on the card and on
    the CPU. (1) The inverses of the matrices on each device: the API's
    (``api._inverses``) must be bit-equal, the solver's
    (``torch.linalg.inv``, which the API used before) are printed; (2)
    every stage of the binned forward from the same inputs on both
    devices, each output bit for bit (``tet_stages.card_vs_cpu``): only
    the march tables' log column and what K4 computes from it may differ;
    (3) the render with each device's own inverses, the solver's and the
    API's: the largest colour and depth errors, the pixels over
    ``TET_CARD_CPU_ATOL``, the ``active`` mask and the saved integer
    state. With the API's inverses the render must hold
    ``TET_CARD_CPU_ATOL`` with the mask and the integer state exact.
    Returns a dict of the findings."""
    from dmesh_renderer_tpu_torch.api import _inverses
    from dmesh_renderer_tpu_torch.ops import tet as pt
    from dmesh_renderer_tpu_torch.tools import tet_stages as ts

    cpu = torch.device("cpu")
    args, h, w, seed = ts.scene(case)
    on = {d: [torch.from_numpy(np.ascontiguousarray(x)).to(d) for x in args]
          for d in (dev, cpu)}
    inv = {"solver": {d: [torch.linalg.inv(on[d][i]) for i in (4, 5)]
                      for d in (dev, cpu)},
           "api": {d: list(_inverses(*on[d][4:6])) for d in (dev, cpu)}}
    inv_diff = {k: [ts.differ(v[dev][i], v[cpu][i]) for i in (0, 1)]
                for k, v in inv.items()}
    first, differing = ts.card_vs_cpu(dev, args, h, w, seed)
    torch.cuda.synchronize()

    def render(d, inverses):
        fa = list(on[d])
        fa[6], fa[7] = inverses
        with pt.first_hit_path("binned"):
            c, dp, act, sv = pt.render_tet_forward(*fa, h, w, seed)
        return [x.cpu() for x in (c, dp, act)], {
            k: sv[k].cpu() for k in ("first_face", "last_face", "last_tet",
                                     "n_contrib")}

    out = {"case": case, "first_stage_not_bit_equal": first,
           "stages_differing": differing}
    for key, by_dev in inv.items():
        want, want_sv = render(cpu, by_dev[cpu])
        got, got_sv = render(dev, by_dev[dev])
        over = ((got[0] - want[0]).abs().amax(dim=1) > TET_CARD_CPU_ATOL) | (
            (got[1] - want[1]).abs()[:, 0] > TET_CARD_CPU_ATOL)
        out[f"{key}_inverses"] = {
            "bit_equal": [e for e, _ in inv_diff[key]],
            "max_diff": [f for _, f in inv_diff[key]],
            "colour_max_err": float((got[0] - want[0]).abs().max()),
            "depth_max_err": float((got[1] - want[1]).abs().max()),
            "pixels_over_tol": int(over.sum()),
            "active_differ": int((got[2] != want[2]).sum()),
            "saved_int_differ": {k: int((got_sv[k] != want_sv[k]).sum())
                                 for k in want_sv}}
    log(f"F4 [{case}]: stages on shared inputs: first not bit-equal: "
        f"{first}; differing: "
        + (", ".join(f"{n} ({f:.3g})" for n, f in differing) or "none"))
    for key in ("solver_inverses", "api_inverses"):
        r = out[key]
        log(f"F4 [{case}] {key}: card vs CPU bit-equal {r['bit_equal']} "
            f"(max diff {r['max_diff']}); render: colour max err "
            f"{r['colour_max_err']:.3g}, depth max err "
            f"{r['depth_max_err']:.3g}, pixels over {TET_CARD_CPU_ATOL} "
            f"{r['pixels_over_tol']}, active differs on "
            f"{r['active_differ']} px, saved integer state differs on "
            f"{r['saved_int_differ']}")
    check(not ts.not_transcendental(differing),
          f"F4 [{case}]: a stage without a transcendental differs card vs "
          f"CPU: {ts.not_transcendental(differing)}")
    r = out["api_inverses"]
    check(all(r["bit_equal"]),
          f"F4 [{case}]: the API's inverses differ card vs CPU: {r}")
    check(r["pixels_over_tol"] == 0 and r["active_differ"] == 0
          and not any(r["saved_int_differ"].values()),
          f"F4 [{case}]: the render on the card is not the CPU's: {r}")
    return out


def tet_phases(dev):
    """Phases 12-14: the tet kernels, the tet serving path and its edge
    cases. Returns (the kernels' JSON entries, a dict of tet numbers)."""
    import dmesh_renderer_tpu_torch as port
    from dmesh_renderer_tpu_torch.ops import reduce as rd
    from dmesh_renderer_tpu_torch.ops import tet as pt
    from dmesh_renderer_tpu_torch.ops import tet_first_hit as pfh
    from dmesh_renderer_tpu_torch.ops import tri_binned as tb
    from dmesh_renderer_tpu_torch.tools import tet_stages as ts

    # ---- K3 and K4 against plain: the small scene, then the headline
    n, jit, gs, b, hs, ws, seed = TET_SMALL
    _u, fs, _bg = tet_user(n, b, jit, gs, dev)
    seq_s, _st, fh_s, mi_s = ts.stages(fs, hs, ws, seed)
    for _n, fn in seq_s[:-1]:
        fn()
    err_s, _g3, _v, _g4, eq_s = compare_tet_kernels(
        fh_s(), mi_s(), f"freudenthal_grid(6), {hs}x{ws}, B=2, seed 17")
    # a ragged image (no multiple of 32): tiles with pixels past the edge
    n, jit, gs, b, hs, ws, seed = TET_RAGGED
    _u, fr, _bg = tet_user(n, b, jit, gs, dev)
    seq_r, _st, fh_r, mi_r = ts.stages(fr, hs, ws, seed)
    for _n, fn in seq_r[:-1]:
        fn()
    err_r, _g3, _v, _g4, eq_r = compare_tet_kernels(
        fh_r(), mi_r(), f"freudenthal_grid({n}), {hs}x{ws}, B=2, seed {seed}")
    err_s = max(err_s, err_r)
    eq_s = (eq_s[0] and eq_r[0], eq_s[1] and eq_r[1])
    # fault F4: the card against the CPU, stage by stage, on the GPU tests'
    # ragged and odd scenes
    f4 = {case: tet_card_vs_cpu(dev, case) for case in F4_CASES}

    H, W = TET_HEADLINE["height"], TET_HEADLINE["width"]
    user, fargs, bg = tet_user(TET_HEADLINE["n_grid"], 1, 0.15, 2, dev)
    seq, st, fh_in, m_in = ts.stages(fargs, H, W)
    for _n, fn in seq[:-1]:
        fn()
    err_h, g3, visits, g4, eq_h = compare_tet_kernels(fh_in(), m_in(),
                                                      "tet headline")
    k3_ms = cuda_ms(lambda: pfh.first_hit(*fh_in()), 2, 10)
    k3_plain_ms = cuda_ms(lambda: pfh.first_hit_plain(*fh_in()), 0, 2)
    k4_ms = cuda_ms(lambda: pt.fwd_march(*m_in()), 2, 10)
    k4_plain_ms = cuda_ms(lambda: pt.fwd_march_plain(*m_in()), 0, 2)

    # ---- the bounds of K3 and K4 on this run's data
    keys = st["keys"]
    n_pix = H * W
    n_pairs = int(keys.total)
    walked = int(g3[4].long().sum())
    n_visits = int(visits.sum())
    # the slots a tile needs: as many as its pixels' longest list walk
    # (the headline's 800x800 is a whole number of 32-px tiles)
    need = visits.reshape(1, H // 32, 32, W // 32, 32).amax(dim=(2, 4))
    need_slots = int(need.sum())
    k3_bytes = (keys.starts.numel() * 8 + need_slots * FH_ROW_BYTES
                + n_pix * 12 + n_pix * 16)
    k3_bound, k3_by, k3_ops_ms, k3_bytes_ms = bound(
        n_visits * OPS_PER_FH_VISIT, k3_bytes)
    out_f, out_i = g4
    nc = out_i[2].long()
    blends = int(nc.sum())
    n_active = int(out_i[3].sum())
    walks = blends - n_active  # every blend but an active ray's last walks
    m = st["march"]
    # per ray the inputs (ray 12, zw 16, first face/tet 8, t/u/v 12) and
    # outputs (40); the tables read once: the 36 geometry columns of
    # tet_geo that the walk reads (not the signs, which tet_nrm carries),
    # tet_nrm, tet_ids and shade
    k4_bytes = (n_pix * (12 + 16 + 8 + 12 + 40)
                + m["tet_geo"].shape[0] * 36 * 4 + m["tet_nrm"].numel() * 4
                + m["tet_ids"].numel() * 4 + m["shade"].numel() * 4)
    k4_bound, k4_by, k4_ops_ms, k4_bytes_ms = bound(
        blends * OPS_PER_BLEND + walks * OPS_PER_NRM_WALK, k4_bytes)
    # the bound of the same walks with the normals rebuilt per step (the
    # work of a K4 that does not read tet_nrm), for comparison
    k4_rebuild_ms = bound(blends * OPS_PER_BLEND + walks * OPS_PER_WALK,
                          k4_bytes)[0]
    k3_dev_ms = profiled_device_ms(lambda: pfh.first_hit(*fh_in()),
                                   "tet_first_hit_kernel")
    k3_sh = k3_shapes(fh_in(), g3[4], visits)
    k4_dev_ms = profiled_device_ms(lambda: pt.fwd_march(*m_in()),
                                   "tet_fwd_march_kernel")
    log(f"K3 at tet headline: {k3_ms:.4f} ms (device {k3_dev_ms:.4f}); "
        f"plain {k3_plain_ms:.2f} ms. "
        f"Work: {n_pairs} pairs, {walked} slots staged, {need_slots} slots "
        f"needed, {n_visits} (pixel, face) tests -> {k3_ops_ms:.4f} ms; "
        f"{k3_bytes} bytes -> {k3_bytes_ms:.4f} ms; bound {k3_bound:.4f} ms "
        f"by {k3_by}")
    rs, rt, occ = (k3_sh["rows_staged"], k3_sh["rounds_per_tile"],
                   k3_sh["lane_occupancy"])
    log(f"K3 shapes at the tet headline: rows staged, quarter blocks with "
        f"256-slot rounds {rs['quarter_blocks_256_slot_rounds']}, tile "
        f"blocks with 32-slot rounds {rs['tile_blocks_32_slot_rounds']} "
        f"({need_slots} needed); 32-slot rounds per tile: in the list "
        f"{rt['in_list']}, walked {rt['walked']}, staged {rt['staged']}; "
        f"lane occupancy (tests over the warps' test slots): 16x2 warps "
        f"{occ['quarter_blocks_16x2_warps']:.4f}, 8x4 warps with a pixel a "
        f"lane {occ['tile_blocks_8x4_warps_1_pixel_a_lane']:.4f}, 16x8 "
        f"warps with 4 pixels a lane "
        f"{occ['tile_blocks_16x8_warps_4_pixels_a_lane']:.4f} (warp-steps "
        f"{k3_sh['warp_steps']})")
    log(f"K4 at tet headline: {k4_ms:.4f} ms (device {k4_dev_ms:.4f}); "
        f"plain {k4_plain_ms:.2f} ms. Work: {blends} blends, {walks} walk "
        f"steps (normals read from tet_nrm) -> {k4_ops_ms:.4f} ms; "
        f"{k4_bytes} bytes -> {k4_bytes_ms:.4f} ms; bound {k4_bound:.4f} ms "
        f"by {k4_by} (with the normals rebuilt per step: "
        f"{k4_rebuild_ms:.4f} ms)")

    # ---- the tet serving path: TetRenderer on the card at the headline
    settings = port.TetRenderSettings(H, W, bg)
    renderer = port.TetRenderer(settings, device="cuda")
    counts = (tb.fwd_composite, tb.bwd_composite, rd.seg_sum, pfh.first_hit,
              pt.fwd_march, pt.bwd_march)
    for c in counts:
        c.launches = 0
    color, depth, active, (ovf, n_rendered) = renderer(*user, return_aux=True)
    torch.cuda.synchronize()
    launches = {"tet_first_hit": pfh.first_hit.launches,
                "tet_fwd_march": pt.fwd_march.launches,
                "tet_bwd_march": pt.bwd_march.launches}
    check(launches == {"tet_first_hit": 1, "tet_fwd_march": 1,
                       "tet_bwd_march": 0},
          f"tet serving path launches {launches}")
    check(color.grad_fn is None, "tet serving path recorded a graph")
    check(all(c.launches == 0 for c in counts[:3]),
          "tet serving path ran a tri kernel")
    check(color.shape == (1, 3, H, W) and depth.shape == (1, 1, H, W)
          and active.shape == (1, H, W), "tet output shapes")
    check(bool(torch.isfinite(color).all() and torch.isfinite(depth).all()),
          "tet output not finite")
    check(float(color.min()) >= 0.0 and float(color.max()) <= 1.0 + 1e-5,
          "tet colour out of range")
    check(not bool(ovf), "tet key capacity overflow at the headline")
    check(int(n_rendered) == TET_HEADLINE_PAIRS,
          f"tet pairs {int(n_rendered)} != {TET_HEADLINE_PAIRS}")
    hit_pixels = int((g3[0] >= 0).sum())
    check(hit_pixels == TET_HEADLINE_HIT_PIXELS,
          f"first-hit pixels {hit_pixels} != {TET_HEADLINE_HIT_PIXELS}")
    n_act = int(active.sum())
    max_walk = int(nc.max())
    check(n_act == n_active, "TetRenderer and the staged K4 disagree")
    seq[-1][1]()
    img = st["image"]
    check(torch.equal(img[0], color) and torch.equal(img[1], depth)
          and torch.equal(img[2], active),
          "staged tet pipeline differs from TetRenderer")
    log(f"tet serving path: launches {launches}; pairs {int(n_rendered)} "
        f"(overflow {bool(ovf)}); first-hit pixels {hit_pixels}; active "
        f"pixels {n_act} (JAX on the CPU: {JAX_CPU_ACTIVE}); longest walk "
        f"{max_walk} (JAX: {JAX_CPU_MAX_WALK}); blend events {blends} (JAX: "
        f"{JAX_CPU_BLENDS}); rays blending > 8 faces {int((nc > 8).sum())}, "
        f"> 11 faces {int((nc > 11).sum())}")
    tet_ms = cuda_ms(lambda: renderer(*user), 2, 10)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    renderer(*user)
    torch.cuda.synchronize()
    tet_peak = torch.cuda.max_memory_allocated() - base_mem
    split = {nm: cuda_ms(fn, 1, 5) for nm, fn in seq}
    log(f"tet forward: {tet_ms:.3f} ms/frame (peak extra memory "
        f"{tet_peak / 2**20:.1f} MiB); stage split (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))

    # the card against the port on the CPU, same inputs (after the timing:
    # the CPU run's threads would disturb it): every stage but
    # the march tables' log column and K4's exp is bit-equal on both
    # (tests/test_torch_gpu_tet.py), so a pixel may differ only where log T
    # crosses log(T_EPS) at another step on the two devices
    _c, _d, act_cpu, sv_cpu = pt.render_tet_forward(
        *[x.cpu() for x in fargs], H, W, 0)
    card_nc, card_act = out_i[2].cpu(), out_i[3].cpu() != 0
    cpu_nc, cpu_act = sv_cpu["n_contrib"].reshape(-1), act_cpu.reshape(-1)
    differ = (card_nc != cpu_nc) | (card_act != cpu_act)
    near = torch.zeros_like(differ)
    log_teps = float(np.log(np.float32(1e-4)))
    for lt in (out_f[4].cpu(), out_f[5].cpu(), sv_cpu["final_log_T"],
               sv_cpu["final_prev_log_T"]):
        near |= (lt.reshape(-1) - log_teps).abs() <= 1e-5
    n_diff, n_near = int(differ.sum()), int((differ & near).sum())
    check(torch.equal(sv_cpu["first_face"].reshape(-1).to(dev), st["ff"]),
          "first hit differs card vs CPU")
    log(f"tet card vs the port on the CPU at the headline: active {n_act} vs "
        f"{int(cpu_act.sum())}, blend events {blends} vs "
        f"{int(cpu_nc.sum())}; {n_diff} pixels differ in n_contrib or "
        f"active, {n_near} of them with log T within 1e-5 of log(T_EPS) on "
        f"a device (the two devices' exp/log differ in the last bits)")
    # the active pixels with other inverses of the same matrices: the
    # card's solver (the API's before F4) and LAPACK's, beside the API's
    # (inverse44) and JAX's on the CPU; a ray that grazes an edge moves
    # with the last bit of the inverse
    act_by_inverse = {"api inverse44": n_act}
    for name, inv in (("card torch.linalg.inv", torch.linalg.inv),
                      ("CPU LAPACK", lambda m: torch.linalg.inv(m.cpu()))):
        fa = list(fargs)
        fa[6], fa[7] = (inv(x).to(dev) for x in fargs[4:6])
        act_by_inverse[name] = int(
            pt.render_tet_forward(*fa, H, W, 0)[2].sum())
    log(f"tet headline active pixels by inverse: {act_by_inverse} (JAX on "
        f"the CPU: {JAX_CPU_ACTIVE})")

    # ---- the tet edge cases on the card
    n, jit, gs, b, hd, wd, _seed = TET_DENSE
    ud, fd, _bgd = tet_user(n, b, jit, gs, dev, seed_offset=1)
    before = pfh.first_hit.launches
    with pt.first_hit_path("dense"):
        dense = pt.render_tet_forward(*fd, hd, wd, 0)
    check(pfh.first_hit.launches == before, "forced dense: K3 launched")
    with pt.first_hit_path("binned"):
        binned = pt.render_tet_forward(*fd, hd, wd, 0)
    check(pfh.first_hit.launches == before + 1, "forced binned: no K3")
    check(torch.equal(dense[2], binned[2]), "dense vs binned active differ")
    for k in ("first_face", "last_face", "last_tet", "n_contrib"):
        check(torch.equal(dense[3][k], binned[3][k]), f"dense vs binned {k}")
    e_db = max(float((dense[i] - binned[i]).abs().max()) for i in (0, 1))
    check(e_db <= 1e-6, f"dense vs binned colour/depth {e_db}")
    u2, f2, _bg2 = tet_user(TET_HEADLINE["n_grid"], 2, 0.15, 2, dev)
    before = (pfh.first_hit.launches, pt.fwd_march.launches)
    c2, d2, a2 = port.TetRenderer(port.TetRenderSettings(H, W, bg), "cuda")(
        *u2)
    torch.cuda.synchronize()
    check((pfh.first_hit.launches, pt.fwd_march.launches)
          == (before[0] + 1, before[1] + 1), "B=2 tet: K3/K4 not once each")
    check(c2.shape == (2, 3, H, W) and bool(torch.isfinite(c2).all())
          and bool(a2[0].any() and a2[1].any()), "B=2 tet outputs")
    check(torch.equal(a2[0], active[0]), "B=2 view 0 active differs from B=1")
    from dmesh_renderer_tpu_torch.ops import rays

    inv_c = [x.cpu() for x in f2[6:8]]
    rj = rays.generate_rays(*f2[6:8], W, H, norm_eps_mode="tet",
                            jitter_seed=17, view_offset=3)[1]
    rc = rays.generate_rays(*inv_c, W, H, norm_eps_mode="tet",
                            jitter_seed=17, view_offset=3)[1]
    check(torch.equal(rj.cpu(), rc), "jittered rays differ card vs CPU")
    r_small = port.TetRenderer(port.TetRenderSettings(64, 48, bg), "cuda")
    u = user
    ce, de, ae, (oe, ne) = r_small(u[0], u[1][:0], u[2], u[3][:0], u[4],
                                   u[5], u[6], u[7][:, :0], u[8], u[9][:0],
                                   u[10], return_aux=True)
    check(bool((ce == bg[None, :, None, None]).all() and (de == 1).all()
               and not ae.any()) and (bool(oe), int(ne)) == (False, 0),
          "empty tet geometry must give bg, depth 1, inactive, (False, 0)")
    log(f"tet edge cases: forced dense (F={fd[1].shape[0]}) vs forced "
        f"binned at "
        f"{hd}x{wd}, B=2: active and saved state equal, colour/depth "
        f"max_abs_err {e_db:.3g}; B=2 headline grid ok (view 0 active equal "
        f"to B=1); jittered rays card == CPU (seed 17, view_offset 3); empty "
        f"geometry fill ok")

    common = {"route": "cuda",
              "source": "dmesh_renderer_tpu_torch/csrc/tet_fwd.cu",
              "library_ms": None}
    kernels = [
        {**common, "name": "tet_first_hit",
         "replaces": "dmesh_renderer_tpu/ops/tet_first_hit.py:51",
         "launches": launches["tet_first_hit"],
         "max_abs_err": max(err_s, err_h), "ms": k3_ms,
         "device_ms": k3_dev_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound, "bound_by": k3_by,
         "bit_equal": bool(eq_s[0] and eq_h[0]), "pairs": n_pairs,
         "slots_staged": walked, "slots_needed": need_slots,
         "visits": n_visits, "hit_pixels": hit_pixels, **k3_sh},
        {**common, "name": "tet_fwd_march",
         "replaces": "dmesh_renderer_tpu/ops/tet.py:503",
         "launches": launches["tet_fwd_march"],
         "max_abs_err": max(err_s, err_h), "ms": k4_ms,
         "device_ms": k4_dev_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound, "bound_by": k4_by,
         "bound_rebuilt_normals_ms": k4_rebuild_ms,
         "bit_equal": bool(eq_s[1] and eq_h[1]), "blends": blends,
         "walk_steps": walks, "active": n_act, "max_walk": max_walk,
         "active_by_inverse": act_by_inverse},
    ]
    info = {"tet_forward_ms": tet_ms, "tet_forward_split_ms": split,
            "tet_forward_peak_mib": tet_peak / 2**20,
            "tet_card_vs_cpu_pixels": [n_diff, n_near],
            "tet_card_vs_cpu_stages": f4}
    head = {"user": user, "fargs": fargs, "bg": bg, "renderer": renderer,
            "u2": u2, "small": fs}
    return kernels, info, head


def tet_upstream(B, h, w, seed, dev):
    """A fixed random upstream gradient: dL/dcolor, dL/ddepth on ``dev``."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, 3, h, w), generator=g).to(dev),
            torch.randn((B, 1, h, w), generator=g).to(dev))


def k5_inputs(fargs, h, w, seed, gc, gd):
    """The tet forward on the card, then the inputs of K5."""
    from dmesh_renderer_tpu_torch.ops import tet as pt

    _c, _d, _a, saved = pt.render_tet_forward(*fargs, h, w, seed)
    ray_i, ray_f, off, n, _total, ovf = pt.bwd_start_state(
        saved, fargs[10], gc, gd, fargs[12])
    check(not bool(ovf), "K5's records passed the static record capacity")
    m = saved["march"]
    return saved, (saved["ray_d"], saved["cam_o"], saved["zw"], ray_i,
                   ray_f, off, n, m["tet_geo"], m["tet_nrm"], m["tet_ids"],
                   m["shade"], h * w)


def compare_k5(fargs, h, w, seed, label, gen_seed):
    """K5 against its plain version on the same CUDA inputs and a fixed
    random upstream gradient: keys, records and mismatch flags, and the two
    gradients reduced from each, bit for bit. Returns (max abs error, the
    mismatch count, K5's inputs and outputs)."""
    from dmesh_renderer_tpu_torch.ops import tet as pt

    gc, gd = tet_upstream(fargs[4].shape[0], h, w, gen_seed,
                          fargs[0].device)
    _saved, inputs = k5_inputs(fargs, h, w, seed, gc, gd)
    before = pt.bwd_march.launches
    got = pt.bwd_march(*inputs)
    torch.cuda.synchronize()
    check(pt.bwd_march.launches == before + 1, "K5 did not launch")
    want = pt.bwd_march_plain(*inputs)
    check(bool(want[1].any()), f"{label}: K5 records all zero")
    # the records on the rows the rays own: the card leaves the record
    # capacity's rows past them unwritten (their key F keeps them out of the
    # reduce)
    live = int(inputs[3][3].long().sum())
    for name, g, p in zip(("keys", "records", "mismatch flags"),
                          (got[0], got[1][:live], got[2]),
                          (want[0], want[1][:live], want[2])):
        check(torch.equal(g, p), f"{label}: K5 {name} differ from plain")
    err = float((got[1][:live] - want[1][:live]).abs().max())
    F, P = fargs[1].shape[0], fargs[0].shape[0]
    gk = pt.reduce_tet_records(*got[:2], fargs[1], P)
    gp = pt.reduce_tet_records(*want[:2], fargs[1], P)
    for g, p in zip(gk, gp):
        err = max(err, float((g - p).abs().max()))
        check(torch.equal(g, p), f"{label}: K5 gradients differ from plain")
    mism = int(got[2].sum())
    log(f"K5 vs plain [{label}]: {int(inputs[3][3].long().sum())} records "
        f"(capacity {inputs[6]}) over "
        f"{int((inputs[3][3] > 0).sum())} rays; keys, records, mismatch "
        f"flags and both gradients bit-equal (max abs err {err:.3g}); "
        f"re-walk mismatches {mism}; faces {F}")
    return err, mism, inputs, got


def tet_train_phases(dev, head):
    """Phases 15-18: K5, the tet training path, the tet train step and the
    tet backward's edge cases. Returns (K5's JSON entry, the extra entries
    of seg_sum at the tet reduce, a dict of tet training numbers)."""
    import dmesh_renderer_tpu_torch as port
    from dmesh_renderer_tpu_torch.models import dmesh
    from dmesh_renderer_tpu_torch.ops import reduce as rd
    from dmesh_renderer_tpu_torch.ops import tet as pt
    from dmesh_renderer_tpu_torch.ops import tet_first_hit as pfh
    from dmesh_renderer_tpu_torch.ops import tri_binned as tb

    H, W = TET_HEADLINE["height"], TET_HEADLINE["width"]
    user, fargs, bg = head["user"], head["fargs"], head["bg"]
    renderer = head["renderer"]
    _n, _jit, _gs, b, hs, ws, seed_s = TET_SMALL

    # ---- K5 against plain: the small scene, then the headline
    err_s, mism_s, _in_s, _out_s = compare_k5(
        head["small"], hs, ws, seed_s,
        f"freudenthal_grid(6), {hs}x{ws}, B=2, seed 17", 1)
    err_h, mism_h, k5_in, k5_out = compare_k5(fargs, H, W, 0,
                                              "tet headline", 0)
    k5_ms = cuda_ms(lambda: pt.bwd_march(*k5_in), 2, 10)
    k5_plain_ms = cuda_ms(lambda: pt.bwd_march_plain(*k5_in), 0, 1)

    # ---- seg_sum against plain at the tet reduce's two shapes
    F, P = fargs[1].shape[0], fargs[0].shape[0]
    keys, rec = k5_out[0], k5_out[1]
    csr = rd.segment_csr(keys, F)  # the rows of key F lie past it
    face_acc = rd.seg_sum(rec, csr)
    corners = face_acc[:, :9].reshape(F * 3, 3)
    csr_v = rd.segment_csr(fargs[1], P)
    ss_err = 0.0
    for label, x, c in (("tet record reduce", rec, csr),
                        ("tet vertex reduce", corners, csr_v)):
        s_k = rd.seg_sum(x, c)
        torch.cuda.synchronize()
        s_p = rd.seg_sum_plain(x, c)
        check(bool(s_p.any()), f"seg_sum {label}: all zero")
        ss_err = max(ss_err, float((s_k - s_p).abs().max()))
        check(torch.equal(s_k, s_p),
              f"seg_sum differs from its plain version at the {label}")
        log(f"seg_sum vs plain at the {label} ({tuple(x.shape)} -> "
            f"{tuple(s_k.shape)}): bitwise equal")
    tet_rec = time_seg_sum(rec, csr, "tet record reduce")
    tet_vtx = time_seg_sum(corners, csr_v, "tet vertex reduce")

    # ---- K5's bound on this run's data
    ray_i = k5_in[3]
    n_rec = int(ray_i[3].long().sum())  # the records, not the capacity
    n_rays = int((ray_i[3] > 0).sum())
    # every ray but its last record walks back one step (all rays retrace
    # the forward when the mismatch count is 0)
    walks = n_rec - n_rays
    M = ray_i.shape[1]
    # the tables, read once: the 36 geometry columns of tet_geo that the
    # walk reads (not the signs, which tet_nrm carries), tet_nrm, tet_ids
    # and shade
    m_tab = k5_in[7].shape[0] * 36 * 4 + sum(x.numel() * 4
                                             for x in k5_in[8:11])
    k5_bytes = (M * (4 + 1) + n_rays * K5_RAY_BYTES + n_rec * K5_REC_BYTES
                + m_tab + k5_in[1].numel() * 4)
    k5_bound, k5_by, k5_ops_ms, k5_bytes_ms = bound(
        n_rec * OPS_PER_BWD_VISIT + walks * OPS_PER_NRM_WALK, k5_bytes)
    log(f"K5 at tet headline: {k5_ms:.4f} ms; plain {k5_plain_ms:.2f} ms. "
        f"Work: {n_rec} records over {n_rays} rays, {walks} walk steps -> "
        f"{k5_ops_ms:.4f} ms; {k5_bytes} bytes -> {k5_bytes_ms:.4f} ms; "
        f"bound {k5_bound:.4f} ms by {k5_by}")
    # the share of K5's lane-visits that are busy: a warp visits as often as
    # its longest ray; in pixel order (the kernel's), over the rays with
    # records only, and over those sorted by length, beside the cheapest
    # ways to build either order
    n_all = ray_i[3].long()
    n_act = n_all[n_all > 0]
    occ = {k: lane_occupancy(v) for k, v in (
        ("pixel order", n_all), ("compacted", n_act),
        ("sorted by length", torch.sort(n_act, descending=True).values))}
    compact_ms = cuda_ms(lambda: torch.nonzero(ray_i[3] > 0), 2, 10)
    sort_ms = cuda_ms(lambda: torch.sort(ray_i[3], stable=True), 2, 10)
    log("K5 lane occupancy: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in occ.items())
        + f"; a compacted ray list costs {compact_ms:.4f} ms "
        f"(torch.nonzero), a sort by length {sort_ms:.4f} ms")

    # ---- the tet training path: TetRenderer with gradients at the headline
    leaves = [user[i].detach().clone().requires_grad_(True) for i in (2, 3)]

    def fwd():
        return renderer(user[0], user[1], leaves[0], leaves[1], *user[4:])

    def fwd_bwd():
        for x in leaves:
            x.grad = None
        c, d, _a = fwd()
        (c.sum() + d.sum()).backward()

    counts = (tb.fwd_composite, tb.bwd_composite, rd.seg_sum, pfh.first_hit,
              pt.fwd_march, pt.bwd_march)
    for c in counts:
        c.launches = 0
    fwd_bwd()
    torch.cuda.synchronize()
    launches = {"tet_first_hit": pfh.first_hit.launches,
                "tet_fwd_march": pt.fwd_march.launches,
                "tet_bwd_march": pt.bwd_march.launches,
                "seg_sum": rd.seg_sum.launches}
    check(launches == {"tet_first_hit": 1, "tet_fwd_march": 1,
                       "tet_bwd_march": 1, "seg_sum": 2},
          f"tet training path launches {launches}")
    check(tb.fwd_composite.launches == 0 and tb.bwd_composite.launches == 0,
          "tet training path ran a tri kernel")
    train_mism = int(pt.bwd_march.mismatches)
    g1 = [x.grad.clone() for x in leaves]
    for x, g in zip(leaves, g1):
        check(g.shape == x.shape and bool(torch.isfinite(g).all())
              and bool(g.any()), "tet training-path gradients")
    fwd_bwd()
    check(all(torch.equal(x.grad, g) for x, g in zip(leaves, g1)),
          "tet headline gradients differ between two runs")
    log(f"tet training path: launches {launches}; re-walk mismatches "
        f"{train_mism}; both gradients finite, nonzero, bitwise equal across "
        f"two runs")
    fb_ms = cuda_ms(fwd_bwd, 2, 10)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    fwd_bwd()
    torch.cuda.synchronize()
    fb_peak = torch.cuda.max_memory_allocated() - base_mem

    ones = (torch.ones((1, 3, H, W), device=dev),
            torch.ones((1, 1, H, W), device=dev))
    saved, in1 = k5_inputs(fargs, H, W, 0, *ones)
    keys1, rec1, _bad1 = pt.bwd_march(*in1)
    acc1 = rd.seg_sum(rec1, rd.segment_csr(keys1, F))
    fb_split = {
        "recording forward": cuda_ms(fwd, 2, 10),
        "start state": cuda_ms(lambda: pt.bwd_start_state(
            saved, fargs[10], *ones, fargs[12]), 2, 10),
        "K5": cuda_ms(lambda: pt.bwd_march(*in1), 2, 10),
        "record reduce": cuda_ms(lambda: rd.seg_sum(
            rec1, rd.segment_csr(keys1, F)), 2, 10),
        "vertex reduce": cuda_ms(lambda: rd.corner_sum(
            fargs[1], P, acc1[:, :9].reshape(F * 3, 3)), 2, 10),
    }
    fb_split["rest"] = fb_ms - sum(fb_split.values())
    for c in counts:
        c.launches = 0
    renderer(*user)
    torch.cuda.synchronize()
    check((pfh.first_hit.launches, pt.fwd_march.launches,
           pt.bwd_march.launches, rd.seg_sum.launches) == (1, 1, 0, 0),
          "the tet serving path after training launched a backward kernel")
    fwd_nograd_ms = cuda_ms(lambda: renderer(*user), 2, 10)
    log(f"tet fwd+bwd: {fb_ms:.3f} ms/frame (peak extra memory "
        f"{fb_peak / 2**20:.1f} MiB); split (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in fb_split.items())
        + f"; the tet forward without gradients, timed next: "
          f"{fwd_nograd_ms:.3f} ms (K3 and K4 once, no K5)")

    # ---- make_tet_train_step with Adam(1e-2, capturable) at the headline
    geom = dmesh.TetGeometry(fargs[0], fargs[1], fargs[9], fargs[10],
                             fargs[11])
    scene = dmesh.TetScene(*[user[i].detach().clone().requires_grad_(True)
                             for i in (2, 3)])
    batch = dmesh.TetViewBatch(*fargs[4:9], torch.zeros((1, 3, H, W),
                                                        device=dev))
    state = dmesh.init_tet_train_state(scene, _adam_capturable)
    step = dmesh.make_tet_train_step(geom, torch.zeros(3, device=dev), H, W)
    losses, step_times = [], []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, loss = step(state, batch)
        e1.record()
        torch.cuda.synchronize()
        step_times.append(e0.elapsed_time(e1))
        losses.append(float(loss))
    check(all(np.isfinite(x) for x in losses), f"tet train losses {losses}")
    check(losses[-1] < losses[0], f"tet train loss did not fall: {losses}")
    check((step.captures, step.replays) == (1, 4),
          f"tet train step: {step.captures} captures, {step.replays} "
          "replays")
    step_ms = float(np.mean(step_times[2:]))
    log(f"tet train step (Adam 1e-2, capturable; zero target and "
        f"background): losses " + ", ".join(f"{x:.6f}" for x in losses)
        + f"; {step_ms:.3f} ms/step (mean of steps 3-5, replays; step 1 "
        f"eager {step_times[0]:.3f} ms, step 2 the capture and a replay "
        f"{step_times[1]:.3f} ms)")

    # ---- the tet backward's edge cases on the card
    fs = head["small"]
    gc, gd = tet_upstream(b, hs, ws, 2, dev)

    def small_grads(t):
        t = list(t)
        for i in (2, 3):
            t[i] = t[i].detach().clone().requires_grad_(True)
        c, d, _a = pt.render_tet_core(*t, hs, ws, seed_s)
        ((c * gc.to(t[0].device)).sum()
         + (d * gd.to(t[0].device)).sum()).backward()
        return t[2].grad, t[3].grad

    g_card = small_grads(fs)
    g_cpu = small_grads([x.cpu() for x in fs])
    e_cc = max(rel(a.cpu(), b_) for a, b_ in zip(g_card, g_cpu))
    check(e_cc <= TET_CARD_CPU_RTOL,
          f"tet gradients card vs CPU: rel err {e_cc}")
    u = user
    bg_leaf = bg.clone().requires_grad_(True)
    r_empty = port.TetRenderer(port.TetRenderSettings(64, 48, bg_leaf),
                               "cuda")
    lv = [u[2].clone().requires_grad_(True), u[3][:0].clone()
          .requires_grad_(True)]
    c, d, _a = r_empty(u[0], u[1][:0], lv[0], lv[1], u[4], u[5], u[6],
                       u[7][:, :0], u[8], u[9][:0], u[10])
    (c.sum() + d.sum()).backward()
    check(all(x.grad is not None and x.grad.shape == x.shape
              and not bool(x.grad.any()) for x in lv),
          "empty tet geometry: verts_color/faces_opacity grads must be zeros")
    check(torch.equal(bg_leaf.grad, torch.full((3,), 64.0 * 48.0,
                                               device=dev)),
          "empty tet geometry: bg must get the fill's gradient")
    u2 = head["u2"]
    lv2 = [u2[i].detach().clone().requires_grad_(True) for i in (2, 3)]
    before = pt.bwd_march.launches
    c2, d2, _a2 = port.TetRenderer(port.TetRenderSettings(H, W, bg), "cuda")(
        u2[0], u2[1], lv2[0], lv2[1], *u2[4:])
    (c2.sum() + d2.sum()).backward()
    torch.cuda.synchronize()
    check(pt.bwd_march.launches == before + 1, "B=2 tet did not run K5")
    check(all(bool(torch.isfinite(x.grad).all() and x.grad.any())
              for x in lv2), "B=2 tet gradients")
    log(f"tet backward edge cases: card vs the port on the CPU at "
        f"freudenthal_grid(6), {hs}x{ws}, B=2: gradients rel err {e_cc:.3g} "
        f"(tol {TET_CARD_CPU_RTOL}); empty geometry: zero gradients, bg the "
        f"fill's; B=2 headline grid with gradients ok")

    k5 = {"route": "cuda", "name": "tet_bwd_march",
          "source": "dmesh_renderer_tpu_torch/csrc/tet_bwd.cu",
          "replaces": "dmesh_renderer_tpu/ops/tet.py:606",
          "launches": launches["tet_bwd_march"],
          "max_abs_err": max(err_s, err_h), "ms": k5_ms,
          "plain_ms": k5_plain_ms, "bound_ms": k5_bound, "bound_by": k5_by,
          "library_ms": None, "records": n_rec, "rays": n_rays,
          "walk_steps": walks, "lane_occupancy": occ,
          "compact_ms": compact_ms, "sort_by_length_ms": sort_ms,
          "rewalk_mismatches": [mism_s, mism_h, train_mism]}
    info = {"tet_fwd_bwd_ms": fb_ms, "tet_fwd_bwd_split_ms": fb_split,
            "tet_fwd_bwd_peak_mib": fb_peak / 2**20,
            "tet_forward_no_grad_after_ms": fwd_nograd_ms,
            "tet_train_step_ms": step_ms, "tet_train_losses": losses,
            "tet_seg_sum_launches": launches["seg_sum"],
            "tet_seg_sum_max_abs_err": ss_err,
            "tet_seg_sum_record": tet_rec, "tet_seg_sum_vertex": tet_vtx,
            "tet_card_vs_cpu_grad_rel_err": e_cc}
    return k5, info


def profiled_device_ms(fn, kernel, reps=10, per_call=1):
    """The mean device time (ms) of one launch of the kernel whose name
    holds ``kernel`` over ``reps`` calls of ``fn()`` (each launching it
    ``per_call`` times) under the profiler: the kernel's own time, without
    the host's launch cost that events around back-to-back calls also
    see."""
    from torch.profiler import ProfilerActivity, profile

    from dmesh_renderer_tpu_torch.utils import diagnostics as dg

    fn()
    torch.cuda.synchronize()
    # The profiler has been seen to return a window without some or all of
    # its device records (0, 7 or 8 of 10 launches; three empty windows in
    # a row once). The mean is taken over the launches a window holds, and
    # said when some are missing; a window that holds none is taken again,
    # at most PROFILE_WINDOWS times in all.
    for attempt in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = dg.device_time_by_name(prof)
        hits = [(c, ms) for n, (c, ms) in by_name.items() if kernel in n]
        want = reps * per_call
        if len(hits) == 1 and 0 < hits[0][0] <= want:
            if hits[0][0] < want:
                log(f"profiled {kernel}: the window holds {hits[0][0]} of "
                    f"its {want} launches; their mean is taken")
            return hits[0][1] / hits[0][0]
        log(f"profiled {kernel}, window {attempt + 1}: {hits} (want up to "
            f"{want} launches of one kernel); {len(by_name)} device names: "
            f"{[n[:60] for n in list(by_name)[:4]]}")
    raise AssertionError(f"profiled {kernel}: no window held its launches")


def _jsonable(x):
    if isinstance(x, dict):
        return {(k if isinstance(k, str) else str(k)): _jsonable(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def tools_main_path(dev):
    """Phase 19: the experiment tools on the card, counts set to 0 just
    before and read just after. Returns the experiments' answers (which
    hold T1-T4's times) and the launch counts."""
    from dmesh_renderer_tpu_torch.tools import exp_round3 as ex
    from dmesh_renderer_tpu_torch.tools import proto_march_kernel as pm

    probes = {"take_rows": ex.take_rows, "roll_merge": ex.roll_merge,
              "mega_step": ex.mega_step, "two_table_step": ex.two_table_step,
              "proto_step": pm.proto_step}
    for c in probes.values():
        c.launches = 0
    t0 = time.perf_counter()
    answers = ex.main([*ex.EXPERIMENTS, "--device", "cuda"])
    answers["proto_march_kernel"] = pm.main(["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in probes.items()}
    for k, n in launches.items():
        check(n >= 1, f"the tools' main path did not launch {k}")
    log(f"tools' main path: launches {launches} ({wall:.1f} s)")
    for name, res in answers.items():
        log(f"answers {name}: {json.dumps(_jsonable(res))}")
    return answers, launches


def _max_diff(pairs):
    """The largest |got - want| over (got, want) pairs of tensors."""
    return max(float((g.double() - w.double()).abs().max()) for g, w in pairs)


def probe_kernel_phases(dev, answers, launches):
    """Phase 20: T1-T4 against their plain versions at full size, on the
    inputs the tools drew in phase 19, with the largest difference; their
    times from the tools' answers, each kernel's device time under the
    profiler, the plain versions' times with the tools' timer, and the
    bounds from this run's bytes and operations. Returns their JSON
    entries."""
    from dmesh_renderer_tpu_torch.tools import exp_round3 as ex
    from dmesh_renderer_tpu_torch.tools import proto_march_kernel as pm

    measure = ex._timer(dev)

    # ---- T1: every table size at the TPU's 8 rows and the march width,
    # e2's draws
    rng = np.random.RandomState(0)
    lane = torch.arange(128, device=dev)
    t1, t1_pairs = {}, []
    for S in PROBE_TABLE_ROWS:
        tab = torch.from_numpy(rng.rand(S, 128).astype(np.float32)).to(dev)
        for R in PROBE_LOOKUP_ROWS:
            idx = torch.from_numpy(
                rng.randint(0, S, (R, 128)).astype(np.int32)).to(dev)
            idx64 = idx.long()
            got = ex.take_rows(tab, idx)
            torch.cuda.synchronize()
            want = ex.take_rows_plain(tab, idx)
            t1_pairs.append((got, want))
            check(torch.equal(got, want), f"T1 S={S} R={R} differs from plain")
            check(torch.equal(got, torch.gather(tab, 0, idx64)),
                  f"T1 S={S} R={R} differs from torch.gather")
            # the table elements the lookups touch, read once; and the
            # floor the card's 32-byte sectors set: each distinct sector
            # the lookups land in is fetched whole
            touched = int(torch.unique(idx64 * 128 + lane).numel())
            sectors = int(torch.unique((idx64 * 128 + lane) // 8).numel())
            b_ms, b_by, _o, _b = bound(2 * R * 128,
                                       2 * R * 128 * 4 + touched * 4)
            sector_ms = (2 * R * 128 * 4 + sectors * 32) / PEAK_BYTES * 1e3
            ms, lib_ms = answers["e2"][(S, R)]
            t1[(S, R)] = dict(
                ms=ms,
                device_ms=profiled_device_ms(
                    lambda: ex.take_rows(tab, idx), "take_rows_kernel"),
                plain_ms=measure(lambda: ex.take_rows_plain(tab, idx)),
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                touched=touched, sectors=sectors, sector_floor_ms=sector_ms)
            r = t1[(S, R)]
            route = "shared memory" if S <= 96 else "L2"
            log(f"T1 take_rows S={S} R={R} ({route}): bit-equal to plain "
                f"and torch.gather; {r['ms']:.4f} ms per call, device "
                f"{r['device_ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f}, torch.gather "
                f"{r['library_ms']:.4f} (no slower: "
                f"{r['ms'] <= r['library_ms']}); {touched} table elements "
                f"touched in {sectors} sectors; bound {b_ms:.5f} ms by "
                f"{b_by}, sector floor {sector_ms:.5f} ms")
    t1_err = _max_diff(t1_pairs)

    # ---- T2: the [5000, 12, 128] buffer, keys in runs of 16
    buf = ex.e3_buffer(PROBE_RAYS).to(dev)
    got = ex.roll_merge(buf)
    torch.cuda.synchronize()
    want = ex.roll_merge_plain(buf)
    t2_err = _max_diff([(got, want)])
    check(torch.equal(got, want), f"T2 differs from plain (max abs {t2_err})")
    G = buf.shape[0]
    t2_bound, t2_by, _o, _b = bound(G * 128 * 7 * (11 * 2 + 2),
                                    2 * buf.numel() * 4)
    t2_ms = answers["e3"]["ms"]
    t2_dev = profiled_device_ms(lambda: ex.roll_merge(buf),
                                "roll_merge_kernel")
    t2_plain = measure(lambda: ex.roll_merge_plain(buf))
    log(f"T2 roll_merge [{G}, 12, 128]: bit-equal to plain; {t2_ms:.4f} ms "
        f"per call, device {t2_dev:.4f} ms, plain {t2_plain:.4f}; "
        f"{2 * buf.numel() * 4} bytes; bound "
        f"{t2_bound:.5f} ms by {t2_by}")

    # ---- T3: both entries at the tet headline's tables, 640,000 rays
    march, mega, ct, consts, state = ex.e5_inputs(dev, 20, PROBE_RAYS)
    tabs = (march["tet_geo"], march["tet_ids"], march["shade"])
    a = ex.mega_step(mega, ct, consts, state)
    b = ex.two_table_step(*tabs, ct, consts, state)
    torch.cuda.synchronize()
    want = ex.mega_step_plain(mega, ct, consts, state)
    t3_err = _max_diff([(a, want), (b, want)])
    check(torch.equal(a, want), f"T3 mega_step differs from plain "
          f"(max abs {t3_err})")
    check(torch.equal(b, want), "T3 two_table_step differs from plain")
    check(torch.equal(ex.two_table_step_plain(*tabs, ct, consts, state),
                      want), "T3's plain entries differ")
    ray_bytes = PROBE_RAYS * T3_RAY_BYTES
    used_tets = torch.unique(ct.long())
    used_faces = torch.unique(march["tet_ids"][used_tets, :4].long()
                              .clamp_min(0))
    mega_bytes = ray_bytes + used_tets.numel() * 96 * 4
    two_bytes = (ray_bytes + used_tets.numel() * 48 * 4
                 + used_faces.numel() * 12 * 4)
    t3_bound, t3_by, _o, _b = bound(PROBE_RAYS * OPS_T3_RAY, mega_bytes)
    t3b_bound, t3b_by, _o, _b = bound(PROBE_RAYS * OPS_T3_RAY, two_bytes)
    t3_ms, t3b_ms = answers["e5"]["mega_ms"], answers["e5"]["two_table_ms"]
    t3_dev = profiled_device_ms(
        lambda: ex.mega_step(mega, ct, consts, state), "mega_step_kernel")
    t3b_dev = profiled_device_ms(
        lambda: ex.two_table_step(*tabs, ct, consts, state),
        "two_table_step_kernel")
    t3_plain = measure(lambda: ex.mega_step_plain(mega, ct, consts, state))
    log(f"T3 at {PROBE_RAYS} rays, T={mega.shape[0]}: mega_step and "
        f"two_table_step bit-equal to plain and to each other; mega "
        f"{t3_ms:.4f} ms per call, device {t3_dev:.4f} ms (bound "
        f"{t3_bound:.5f} by {t3_by}, {mega_bytes} bytes), two-table "
        f"{t3b_ms:.4f} ms, device {t3b_dev:.4f} ms (bound {t3b_bound:.5f} by "
        f"{t3b_by}, {two_bytes} bytes), plain {t3_plain:.3f} ms; "
        f"{used_tets.numel()} tets and {used_faces.numel()} faces touched")

    # ---- T4: the tool's random tables, step 1 and the 8-step chain; then
    # the headline mesh (e5's tables and rays), where rays advance, step 1
    # and a 2-step chain
    t4_pairs = []

    def t4_check(tabs, steps, label):
        s1 = pm.proto_step(*tabs)
        torch.cuda.synchronize()
        w1 = pm.proto_step_plain(*tabs)
        t4_pairs.append((s1, w1))
        check(torch.equal(s1, w1), f"T4 step 1 on {label} differs from plain")
        got = pm.chain(*tabs, steps=steps)
        want = pm.chain(*tabs, steps=steps, step=pm.proto_step_plain)
        t4_pairs.extend(zip(got, want))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"T4 {steps}-step chain on {label} differs from plain")
        return s1, got[0]

    ptabs = pm.random_tables(dev)
    s1, _sc = t4_check(ptabs, pm.REPS, "the random tables")
    _s, cf1, ct1 = pm.chain(*ptabs, steps=1)
    n_cf, n_ct = int(torch.unique(cf1).numel()), int(torch.unique(ct1).numel())
    n_err = int(s1[11].sum())
    mtabs = pm.mesh_tables(dev, 20, PROBE_RAYS)
    m1, m2 = t4_check(mtabs, 2, "the mesh")
    # a lane advanced where it did not err and T stayed above 1e-4
    n_adv = [int(((s[11] == 0) & (s[5] > 1e-4)).sum()) for s in (m1, m2)]
    check(n_adv[0] > 0 and n_adv[1] > 0,
          f"T4 on the mesh: no lane advanced ({n_adv})")
    t4_err = _max_diff(t4_pairs)
    ray4 = PROBE_RAYS * T4_RAY_BYTES
    s1_bytes = (ray4 + torch.unique(ptabs[2]).numel() * 48 * 4
                + torch.unique(ptabs[3]).numel() * 12 * 4)
    chain_bytes = s1_bytes + (pm.REPS - 1) * (ray4 + 48 * 4 + 12 * 4)
    t4_bound, t4_by, _o, _b = bound(PROBE_RAYS * OPS_T4_RAY, s1_bytes)
    t4c_bound, t4c_by, _o, _b = bound(pm.REPS * PROBE_RAYS * OPS_T4_RAY,
                                      chain_bytes)
    pa = answers["proto_march_kernel"]
    t4_ms, t4c_step_ms = pa["step1_ms"], pa["chain_ms_per_step"]
    t4_dev = profiled_device_ms(lambda: pm.proto_step(*ptabs),
                                "proto_step_kernel")
    # the kernel's own time per chained step, beside the chain's per-step
    # total, which also holds the tool's torch glue between steps
    t4c_dev = profiled_device_ms(lambda: pm.chain(*ptabs), "proto_step_kernel",
                                 reps=2, per_call=pm.REPS)
    t4_plain = measure(lambda: pm.proto_step_plain(*ptabs))
    log(f"T4 proto_step at {PROBE_RAYS} rays: step 1 and the {pm.REPS}-step "
        f"chain on the random tables, step 1 and the 2-step chain on the "
        f"mesh, bit-equal to plain; step 1 {t4_ms:.4f} ms per call, device "
        f"{t4_dev:.4f} ms (bound {t4_bound:.5f} by {t4_by}), chain "
        f"{t4c_step_ms:.4f} ms/step, of which the kernel's device time "
        f"{t4c_dev:.4f} ms/step (bound {t4c_bound / pm.REPS:.5f} "
        f"ms/step by {t4c_by}), plain step {t4_plain:.3f} ms; random "
        f"tables: error lanes {n_err} of {PROBE_RAYS}, after step 1 {n_cf} "
        f"distinct faces and {n_ct} distinct tets; mesh: {n_adv[0]} lanes "
        f"advanced at step 1, {n_adv[1]} at step 2")

    main_t1 = t1[(PROBE_TABLE_ROWS[-1], PROBE_LOOKUP_ROWS[-1])]
    return [
        {"route": "cuda", "name": "take_rows",
         "source": "dmesh_renderer_tpu_torch/csrc/probes.cu",
         "replaces": "tools/exp_round3.py:151",
         "launches": launches["take_rows"], "max_abs_err": t1_err,
         **{k: main_t1[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "sector_floor_ms")},
         "shape": [PROBE_TABLE_ROWS[-1], PROBE_LOOKUP_ROWS[-1], 128],
         "by_shape": {f"S={S},R={R}": v for (S, R), v in t1.items()}},
        {"route": "cuda", "name": "roll_merge",
         "source": "dmesh_renderer_tpu_torch/csrc/probes.cu",
         "replaces": "tools/exp_round3.py:194",
         "launches": launches["roll_merge"], "max_abs_err": t2_err,
         "ms": t2_ms, "device_ms": t2_dev, "plain_ms": t2_plain,
         "bound_ms": t2_bound,
         "bound_by": t2_by, "library_ms": None, "shape": [G, 12, 128]},
        {"route": "cuda", "name": "mega_step",
         "source": "dmesh_renderer_tpu_torch/csrc/march_probe.cu",
         "replaces": "tools/exp_round3.py:304",
         "launches": launches["mega_step"], "max_abs_err": t3_err,
         "ms": t3_ms, "device_ms": t3_dev, "plain_ms": t3_plain,
         "bound_ms": t3_bound, "bound_by": t3_by, "library_ms": None,
         "launches_two_table": launches["two_table_step"],
         "two_table_ms": t3b_ms, "two_table_device_ms": t3b_dev,
         "two_table_bound_ms": t3b_bound,
         "rays": PROBE_RAYS},
        {"route": "cuda", "name": "proto_step",
         "source": "dmesh_renderer_tpu_torch/csrc/march_probe.cu",
         "replaces": "tools/proto_march_kernel.py:54",
         "launches": launches["proto_step"], "max_abs_err": t4_err,
         "ms": t4_ms, "device_ms": t4_dev, "plain_ms": t4_plain,
         "bound_ms": t4_bound, "bound_by": t4_by, "library_ms": None,
         "chain_ms_per_step": t4c_step_ms,
         "chain_device_ms_per_step": t4c_dev,
         "chain_bound_ms_per_step": t4c_bound / pm.REPS,
         "error_lanes_step1": n_err, "distinct_faces_after_step1": n_cf,
         "distinct_tets_after_step1": n_ct,
         "mesh_lanes_advanced": n_adv},
    ]


def host_us(fn, n=LAUNCH_CALLS, rounds=3):
    """Host microseconds per call of ``fn()``: the least of ``rounds``
    means over ``n`` back-to-back calls (perf_counter; the card is drained
    before each round and not waited for inside it)."""
    fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return best


def _checks_before(tab, idx):
    """T1's wrapper checks as they were before the lean call path: shape
    tuples built per check, a generator over the devices."""
    S, R = tab.shape[0], idx.shape[0]
    for t, dtype, shape in ((tab, torch.float32, (S, 128)),
                            (idx, torch.int32, (R, 128))):
        if t.dtype != dtype:
            raise TypeError("take_rows: dtype")
        if tuple(t.shape) != tuple(shape):
            raise ValueError("take_rows: shape")
    if S == 0:
        raise ValueError("take_rows: empty table")
    dev = tab.device
    if any(t.device != dev for t in (tab, idx)):
        raise ValueError("take_rows: devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("take_rows: device")
    return dev.type == "cuda"


def _launch_before(fn, tensors, scalars, device):
    """``kernels.launch`` as it was before the lean call path: a
    ``torch.cuda.device`` context, a ``Stream`` object for the handle, a
    ``c_void_p`` per pointer."""
    import ctypes

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[ctypes.c_void_p(t.data_ptr()) for t in tensors], *scalars,
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def launch_path_split(dev):
    """The host cost of one T1 call, piece by piece, in us per call over
    LAUNCH_CALLS calls (``host_us``), the call path before the lean one
    (rebuilt here from its pieces) beside the one ``kernels.launch`` takes
    now. At S 48,000 and R 8, where the kernel's device time is below the
    host's, so the card never holds the host back."""
    import ctypes

    from dmesh_renderer_tpu_torch import kernels
    from dmesh_renderer_tpu_torch.tools import exp_round3 as ex

    rng = np.random.RandomState(1)
    S, R = 48_000, 8
    tab = torch.from_numpy(rng.rand(S, 128).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.randint(0, S, (R, 128)).astype(np.int32)).to(dev)
    out = torch.empty((R, 128), device=dev)
    fn = kernels.launcher("probes", "take_rows")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tab, idx, out)]
    iptrs = [t.data_ptr() for t in (tab, idx, out)]
    index = tab.device.index
    idx64 = idx.long()

    def checks_now():
        ex._want("take_rows", tab, torch.float32, (S, ex.LANES))
        ex._want("take_rows", idx, torch.int32, (R, ex.LANES))
        return ex._on_cuda("take_rows", tab, idx)

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    def take_rows_before():
        _checks_before(tab, idx)
        t, i = ex._aligned16(tab), idx.contiguous()
        o = torch.empty((R, 128), dtype=torch.float32, device=dev)
        _launch_before(fn, [t, i, o], [S, R], dev)
        return o

    before = {
        "checks": host_us(lambda: _checks_before(tab, idx)),
        "output allocation": host_us(
            lambda: torch.empty((R, 128), dtype=torch.float32, device=dev)),
        "torch.cuda.device enter and exit": host_us(device_ctx),
        "stream lookup (current_stream().cuda_stream)": host_us(
            lambda: torch.cuda.current_stream().cuda_stream),
        "c_void_p wraps (4)": host_us(
            lambda: [ctypes.c_void_p(p) for p in (*iptrs, stream)]),
        "ctypes call (c_void_p arguments)": host_us(
            lambda: fn(*ptrs, S, R, ctypes.c_void_p(stream))),
        "launch, whole": host_us(
            lambda: _launch_before(fn, [tab, idx, out], [S, R], dev)),
        "take_rows, whole": host_us(take_rows_before),
    }
    now = {
        "checks": host_us(checks_now),
        "output allocation": before["output allocation"],
        "device test (_current_device)": host_us(
            lambda: index != kernels._current_device()),
        "stream lookup (_raw_stream)": host_us(
            lambda: kernels._raw_stream(index)),
        "pointers as ints (3)": host_us(
            lambda: [t.data_ptr() for t in (tab, idx, out)]),
        "ctypes call (int arguments)": host_us(
            lambda: fn(*iptrs, S, R, stream)),
        "launch, whole": host_us(lambda: kernels.launch(
            "probes", "take_rows", [tab, idx, out], [S, R], dev)),
        "take_rows, whole": host_us(lambda: ex.take_rows(tab, idx)),
        "torch.gather, whole": host_us(
            lambda: torch.gather(tab, 0, idx64)),
    }
    check(torch.equal(take_rows_before(), ex.take_rows(tab, idx)),
          "T1 through the two call paths differs")
    log(f"launch path of one T1 call (S {S}, R {R}; host us per call, least "
        f"of 3 means of {LAUNCH_CALLS}): before: "
        + ", ".join(f"{k} {v:.2f}" for k, v in before.items())
        + "; now: " + ", ".join(f"{k} {v:.2f}" for k, v in now.items()))
    return {"shape": [S, R, 128], "calls": LAUNCH_CALLS,
            "before_us": before, "now_us": now}


def diagnostics_phases(dev, tri_fargs, tet_head):
    """Phases 21-22: the diagnostics at the headlines, and a trace of one
    tet and one tri training frame. Returns a dict of their numbers."""
    import dmesh_renderer_tpu_torch as port
    from dmesh_renderer_tpu_torch.utils import diagnostics as dg

    H, W = HEADLINE["height"], HEADLINE["width"]
    stats = dg.tri_render_stats(tri_fargs[0], tri_fargs[1], tri_fargs[4],
                                tri_fargs[5], H, W)
    check(stats["num_rendered"] == HEADLINE_PAIRS and not stats["overflow"],
          f"tri_render_stats at the headline: {stats}")
    TH, TW = TET_HEADLINE["height"], TET_HEADLINE["width"]
    user, renderer = tet_head["user"], tet_head["renderer"]
    _c, _d, active = renderer(*user)
    health = dg.tet_health(active)
    check(health["inactive_pixels"] == TH * TW - TET_HEADLINE_ACTIVE,
          f"tet_health at the tet headline: {health}")
    log(f"diagnostics: tri_render_stats at the headline {stats}; tet_health "
        f"at the tet headline {health}")

    tri_r = port.TriRenderer(port.TriRenderSettings(H, W, tri_fargs[10]),
                             "cuda")
    tri_user = tet_head["tri_user"]
    tri_leaves = leaves_of(tri_user)
    tet_leaves = [user[i].detach().clone().requires_grad_(True)
                  for i in (2, 3)]

    def tet_frame():
        c, d, _a = renderer(user[0], user[1], tet_leaves[0], tet_leaves[1],
                            *user[4:])
        (c.sum() + d.sum()).backward()

    def tri_frame():
        lv = tri_leaves
        c, d = tri_r(lv[0], tri_user[1], lv[1], lv[2], tri_user[4],
                     tri_user[5], lv[3], lv[4])
        (c.sum() + d.sum()).backward()

    timer = dg.StageTimer()
    out = {}
    for name, frame in (("tet", tet_frame), ("tri", tri_frame)):
        plain_frame_ms = cuda_ms(frame, 2, 5)  # without the profiler
        with dg.trace(str(TRACE_DIR)) as prof:
            with timer.stage(f"{name} training frame"):
                frame()
        busy = dg.device_busy_ms(prof)
        by_name = dg.device_time_by_name(prof)
        frame_ms = timer.times[f"{name} training frame"] * 1e3
        check(busy > 0, f"the {name} trace holds no device activity")
        n_dev = sum(c for c, _ms in by_name.values())
        syncs = sum(1 for e in prof.events() if "Synchronize" in e.name)
        top = [(n.replace("(anonymous namespace)::", "").split("(")[0]
                [-48:], c, round(ms, 4))
               for n, (c, ms) in list(by_name.items())[:6]]
        out[name] = {"busy_ms": busy, "frame_ms_profiled": frame_ms,
                     "frame_ms": plain_frame_ms,
                     "busy_share": busy / plain_frame_ms,
                     "busy_share_profiled": busy / frame_ms,
                     "device_events": n_dev, "host_syncs": syncs,
                     "top_device": top,
                     "trace": Path(prof.trace_path).name}
        log(f"trace of one {name} training frame: device busy {busy:.3f} ms "
            f"in {n_dev} device events; the frame {plain_frame_ms:.3f} ms "
            f"unprofiled (busy share {busy / plain_frame_ms:.3f}), "
            f"{frame_ms:.3f} ms profiled (busy share {busy / frame_ms:.3f}); "
            f"{syncs} host synchronisations; the largest device times "
            f"(name, count, ms): {top}; {prof.trace_path}")
    return {"tri_render_stats": stats, "tet_health": health, "traces": out}


# ---- multi-view training, checkpoint/resume, the example loops

# The multi-view headlines: the tri and tet headline scenes at two views,
# one per rank; the tet rays jittered (seed 3), so that each rank's view
# offset keys its jitter. Both ranks share the one card, over gloo.
MV_CFG = {"ranks": 2,
          "tri": dict(n_tris=100_000, n_views=2, height=800, width=800,
                      seed=0),
          "tet": dict(n_grid=20, n_views=2, height=800, width=800,
                      ray_seed=3)}
MV_STEPS = 5  # Adam(1e-2) steps of each run, and runs of them
MV_WARMUP, MV_TIMED = 2, 10  # sharded steps: warm-ups, then timed
MV_TIMEOUT = 300.0  # seconds for the ranks' whole run
# one process's B=2 step against the 2-rank step: JAX's test_sharding.py
# tolerances (loss rtol 1e-6 tri, 2e-5 tet; parameters rtol 2e-5, atol
# 1e-7), and the gradients at the binned path's 1e-4 rel
MV_LOSS_RTOL = {"tri": 1e-6, "tet": 2e-5}
# the kernels each rank must launch once per sharded step
MV_KERNELS = {"tri": ("tri_fwd_composite", "tri_bwd_composite"),
              "tet": ("tet_first_hit", "tet_fwd_march", "tet_bwd_march")}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launch_counters():
    """Each main-path kernel wrapper, by the name the ``kernels`` line
    gives it (``seg_sum`` once: the tri and tet reduces share it)."""
    from dmesh_renderer_tpu_torch.ops import reduce as rd
    from dmesh_renderer_tpu_torch.ops import tet, tet_first_hit
    from dmesh_renderer_tpu_torch.ops import tri_binned as tb

    return {"tri_fwd_composite": tb.fwd_composite,
            "tri_bwd_composite": tb.bwd_composite, "seg_sum": rd.seg_sum,
            "tet_first_hit": tet_first_hit.first_hit,
            "tet_fwd_march": tet.fwd_march, "tet_bwd_march": tet.bwd_march}


def mv_problem(kind, cfg, dev):
    """The multi-view problem ``kind`` ("tri" or "tet") on ``dev``, every
    view: (fresh(optimizer, mesh) -> TrainState, the step builder
    mesh -> step, the B-view batch). Zero target and background."""
    from dmesh_renderer_tpu_torch import parallel
    from dmesh_renderer_tpu_torch.models import dmesh

    c = cfg[kind]
    H, W, B = c["height"], c["width"], c["n_views"]
    zeros = torch.zeros(3, device=dev)
    target = torch.zeros((B, 3, H, W), device=dev)
    if kind == "tri":
        user, fargs, _bg = scene_tensors(
            c["n_tris"], B, H, W, c["seed"], dev)
        leaves = (fargs[0], fargs[2], fargs[3])
        batch = dmesh.ViewBatch(*fargs[4:10], target)

        def make_step(mesh, capture=True):
            return dmesh.make_train_step(fargs[1], zeros, H, W, mesh=mesh,
                                         capture=capture)
    else:
        user, fargs, _bg = tet_user(c["n_grid"], B, 0.15, 2, dev)
        leaves = (fargs[2], fargs[3])
        batch = dmesh.TetViewBatch(*fargs[4:9], target)
        geom = dmesh.TetGeometry(fargs[0], fargs[1], *fargs[9:12])

        def make_step(mesh, capture=True):
            return dmesh.make_tet_train_step(geom, zeros, H, W, mesh=mesh,
                                             seed=c["ray_seed"],
                                             capture=capture)

    scene_type = dmesh.TriScene if kind == "tri" else dmesh.TetScene

    def fresh(optimizer, mesh=None):
        scene = scene_type(*(x.detach().clone().requires_grad_(True)
                             for x in leaves))
        if mesh is not None:
            scene = parallel.replicate_params(mesh, scene)
        return dmesh.init_train_state(scene, optimizer)

    return fresh, make_step, batch


def _sgd(params):
    return torch.optim.SGD(params, lr=1e-2)


def _adam(params):
    return torch.optim.Adam(params, lr=1e-2)


def _adam_capturable(params):
    return torch.optim.Adam(params, lr=1e-2, capturable=True)


def digest(tensors):
    """The bits of ``tensors``, hashed: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def median_ms(fn, dev, warmup=MV_WARMUP, reps=MV_TIMED):
    """Median host ms of ``fn()`` over ``reps`` calls, each ended by a
    device synchronisation, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _ladder(points, time_pair):
    """Time the dense and the binned path at each of ``points`` (rising
    face counts): ``time_pair(point, path)`` gives the path's ms. Once the
    dense path was ``LADDER_GIVE_UP`` times slower than the binned one at
    two points in a row, it is not timed at the larger ones (its cost
    rises with the face count: a Python loop over the faces). Returns
    {point: {"dense": ms or None, "binned": ms}}."""
    out, lost = {}, 0
    for p in points:
        binned, dense = time_pair(p, "binned"), None
        if lost < 2:
            dense = time_pair(p, "dense")
            lost = lost + 1 if dense > LADDER_GIVE_UP * binned else 0
        out[p] = {"dense": dense, "binned": binned}
    return out


def _crossover(row):
    """The largest face count at which the dense path was faster (0 if it
    never was)."""
    won = [p for p, t in row.items()
           if t["dense"] is not None and t["dense"] < t["binned"]]
    return max(won, default=0)


def dispatch_ladder(dev):
    """The dense path against the binned one on the card, for the
    dispatch thresholds: tri (``render_tri_auto(force=...)``, B=1,
    ``tri_scene``) at ``TRI_LADDER_FACES`` and ``TRI_LADDER_SIZES``; tet
    (``TetRenderer``, the dense first hit against the binned one forced)
    on ``freudenthal_grid(n)`` at ``TET_LADDER_GRIDS``, ``LADDER_SIDE``
    squared; each the
    forward without gradients and fwd+bwd of sum(color) + sum(depth),
    ``median_ms`` of ``LADDER_TIMED`` calls after ``LADDER_WARMUP``, both
    paths in this run. Returns the ladders and
    the values they give beside the values set."""
    import dmesh_renderer_tpu_torch as port
    from dmesh_renderer_tpu_torch.ops import tet as pt
    from dmesh_renderer_tpu_torch.ops import tri as ptri
    from dmesh_renderer_tpu_torch.ops.tri import render_tri_auto

    t0 = time.perf_counter()
    tri = {}
    for size in TRI_LADDER_SIZES:
        scenes = {}

        def tri_time(F, path, grad):
            if F not in scenes:
                scenes[F] = scene_tensors(F, 1, size, size, 0, dev)
            user, fargs, _bg = scenes[F]
            force = "oracle" if path == "dense" else "binned"
            if not grad:
                def run():
                    with torch.no_grad():
                        render_tri_auto(*fargs, size, size, force=force)
            else:
                def run():
                    lv = leaves_of(user)
                    c, d = render_tri_auto(lv[0], fargs[1], lv[1], lv[2],
                                           *fargs[4:8], lv[3], lv[4],
                                           fargs[10], size, size, force=force)
                    (c.sum() + d.sum()).backward()
            return median_ms(run, dev, LADDER_WARMUP, LADDER_TIMED)

        for grad in (False, True):
            tri[f"{size}x{size} {'fwd+bwd' if grad else 'fwd'}"] = _ladder(
                TRI_LADDER_FACES, lambda F, p: tri_time(F, p, grad))
    tri_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    tet, tet_faces = {}, {}
    S = LADDER_SIDE
    renderer = port.TetRenderer(port.TetRenderSettings(S, S, np.array(
        [0.1, 0.2, 0.3], np.float32)), device=dev)
    users = {}

    def tet_time(n, path, grad):
        if n not in users:
            users[n] = tet_user(n, 1, 0.15, 2, dev)[0]
            tet_faces[n] = int(users[n][1].shape[0])
        u = users[n]

        def run():
            with pt.first_hit_path(path):
                if not grad:
                    with torch.no_grad():
                        renderer(*u)
                    return
                vc, fo = (x.clone().requires_grad_(True) for x in u[2:4])
                c, d, _a = renderer(u[0], u[1], vc, fo, *u[4:])
                (c.sum() + d.sum()).backward()
        return median_ms(run, dev, LADDER_WARMUP, LADDER_TIMED)

    for grad in (False, True):
        tet[f"{S}x{S} {'fwd+bwd' if grad else 'fwd'}"] = _ladder(
            TET_LADDER_GRIDS, lambda n, p: tet_time(n, p, grad))
    tet_s = time.perf_counter() - t1

    key = f"{S}x{S} fwd+bwd"
    tri_value = _crossover(tri[key])
    tet_n = _crossover(tet[key])
    tet_value = tet_faces[tet_n] if tet_n else 0
    def ms(x):
        return "not timed" if x is None else f"{x:.3f}"

    for name, rows, label in (("tri", tri, "F"), ("tet", tet, "grid n")):
        for k, row in rows.items():
            log(f"ladder {name} {k} (ms, dense / binned by {label}"
                + (", faces " + str(tet_faces) if name == "tet" else "")
                + "): " + "; ".join(f"{p}: {ms(t['dense'])} / "
                                    f"{ms(t['binned'])}"
                                    for p, t in row.items()))
    others = {k: _crossover(r) for k, r in tri.items()}
    log(f"ladder: the card's values from this run, the largest face count "
        f"at which the dense path is faster in fwd+bwd at {S}x{S}: tri "
        f"{tri_value} (set: BINNED_THRESHOLD_GPU = "
        f"{ptri.BINNED_THRESHOLD_GPU}), tet {tet_value} (set: "
        f"BINNED_FIRST_HIT_THRESHOLD_GPU = "
        f"{pt.BINNED_FIRST_HIT_THRESHOLD_GPU}); tri at every size and mode "
        f"{others}; tet {({k: _crossover(r) for k, r in tet.items()})} "
        f"(grid n); {tri_s:.1f} s tri, {tet_s:.1f} s tet")
    return {"tri": {k: {str(p): t for p, t in r.items()}
                    for k, r in tri.items()},
            "tet": {k: {str(p): t for p, t in r.items()}
                    for k, r in tet.items()},
            "tet_faces": tet_faces, "tri_value": tri_value,
            "tet_value": tet_value, "tri_set": ptri.BINNED_THRESHOLD_GPU,
            "tet_set": pt.BINNED_FIRST_HIT_THRESHOLD_GPU,
            "seconds": [tri_s, tet_s]}


def fuzz_phases(dev):
    """Both parity fuzz harnesses on the card: the tri sweep (the JAX
    harness's 40 seeds from 1000, ``FUZZ_TRI``, then ``FUZZ_BIG_TRI``
    configs of ``--big``) and the tet sweep (30 seeds from 2000,
    ``FUZZ_TET``, each with both first hits, then ``FUZZ_BIG_TET`` configs
    of ``--big``). Any failure, or a
    sweep in which one of its kernels never launched, raises."""
    from dmesh_renderer_tpu_torch.tools import fuzz_tet_parity as ftet
    from dmesh_renderer_tpu_torch.tools import fuzz_tri_parity as ftri

    out = {}
    for name, mod, (start, n), big in (
            ("tri", ftri, FUZZ_TRI, False),
            ("tri --big", ftri, (FUZZ_TRI[0], FUZZ_BIG_TRI), True),
            ("tet", ftet, FUZZ_TET, False),
            ("tet --big", ftet, (FUZZ_TET[0], FUZZ_BIG_TET), True)):
        t0 = time.perf_counter()
        results, launched = mod.sweep(range(start, start + n), dev, big)
        secs = time.perf_counter() - t0
        fails = [f"{label}: {'; '.join(e)}" for label, e in results if e]
        log(f"fuzz {name}: {len(results)} configs from seed {start}, "
            f"{len(fails)} failures, launches {launched}, {secs:.1f} s")
        check(not fails, f"fuzz {name} failed: {fails}")
        check(all(launched[k] > 0 for k in mod.KERNELS),
              f"fuzz {name}: a kernel never launched: {launched}")
        out[name] = {"configs": len(results), "failures": fails,
                     "launches": launched, "seconds": secs}
    return out


def mv_rank():
    """One rank of the multi-view phases: for each of tri and tet, one SGD
    step, two runs of ``MV_STEPS`` Adam steps (each step's launch counts,
    set to 0 just before it; loss; parameter digest), the sharded step's
    median ms and the collective's alone."""
    from dmesh_renderer_tpu_torch import parallel

    started = time.time()
    mesh = parallel.make_view_mesh()
    dev = mesh.device
    counters = launch_counters()
    out = {"rank": mesh.rank, "size": mesh.size, "device": str(dev),
           "started": started}
    for kind in ("tri", "tet"):
        fresh, make_step, batch = mv_problem(kind, MV_CFG, dev)
        local = parallel.shard_view_batch(mesh, batch)
        step = make_step(mesh)
        r = {"local_views": int(local.mv_t.shape[0])}
        st, loss = step(fresh(_sgd, mesh), local)
        r["sgd"] = {"loss": float(loss),
                    "scene": [p.detach().cpu() for p in st.scene],
                    "grads": [p.grad.cpu() for p in st.scene]}
        for run in range(2):
            st = fresh(_adam, mesh)
            losses, digests, counts = [], [], []
            for _ in range(MV_STEPS):
                for w in counters.values():
                    w.launches = 0
                st, loss = step(st, local)
                sync(dev)
                counts.append({k: w.launches for k, w in counters.items()})
                losses.append(float(loss))
                digests.append(digest(st.scene))
            r[f"adam_{run}"] = {"losses": losses, "digests": digests,
                                "launches": counts}
        r["step_ms"] = median_ms(lambda: step(st, local), dev)
        n = sum(p.numel() for p in st.scene) + (1 if kind == "tri" else 2)
        flat = torch.ones(n, device=dev)
        r["collective_ms"] = median_ms(
            lambda: parallel.all_reduce(mesh, flat), dev)
        r["collective_values"] = n
        out[kind] = r
        del st, local, batch
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["ended"] = time.time()
    return out


def multi_view_phases(dev):
    """Phase 23: the sharded train steps of both renderers at the
    multi-view headlines, on 2 ranks that share the card (gloo): each
    rank's SGD step against one process's B=2 step on the same batch, the
    Adam runs (falling loss; both ranks' bits equal after every step; the
    second run equal to the first), the launches per rank per step, and the
    times beside one process's B=2 step. Returns the numbers."""
    from dmesh_renderer_tpu_torch import parallel

    backend = parallel.default_backend(MV_CFG["ranks"], "cuda")
    t0, wall0 = time.perf_counter(), time.time()
    ranks = parallel.spawn(mv_rank, MV_CFG["ranks"], backend=backend,
                           timeout=MV_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    start_s = max(r["started"] for r in ranks) - wall0
    work_s = max(r["ended"] for r in ranks) - max(r["started"] for r in ranks)
    check([r["rank"] for r in ranks] == list(range(MV_CFG["ranks"])),
          "ranks missing")
    out = {"ranks": MV_CFG["ranks"], "backend": backend,
           "devices": [r["device"] for r in ranks], "spawn_s": spawn_s,
           "rank_start_s": start_s, "rank_work_s": work_s}
    for kind in ("tri", "tet"):
        rs = [r[kind] for r in ranks]
        fresh, make_step, batch = mv_problem(kind, MV_CFG, dev)
        # one process's eager step, beside the sharded (eager) ones
        step = make_step(None, capture=False)
        st, loss = step(fresh(_sgd), batch)
        want_loss = float(loss)
        want = [p.detach().cpu() for p in st.scene]
        want_g = [p.grad.cpu() for p in st.scene]
        sgd = [r["sgd"] for r in rs]
        check(all(s["loss"] == sgd[0]["loss"] for s in sgd)
              and all(torch.equal(a, b) for s in sgd[1:]
                      for a, b in zip(s["scene"], sgd[0]["scene"])),
              f"{kind}: the ranks' parameters differ after the SGD step")
        loss_rel = abs(sgd[0]["loss"] - want_loss) / abs(want_loss)
        check(loss_rel <= MV_LOSS_RTOL[kind],
              f"{kind}: sharded loss {sgd[0]['loss']} vs one process "
              f"{want_loss}")
        p_err = 0.0
        for a, b in zip(sgd[0]["scene"], want):
            check(bool(torch.isclose(a, b, rtol=2e-5, atol=1e-7).all()),
                  f"{kind}: sharded parameters vs one process")
            p_err = max(p_err, float((a - b).abs().max()))
        g_err = max(rel(a, b) for a, b in zip(sgd[0]["grads"], want_g))
        check(g_err <= GRAD_RTOL and all(bool(g.any()) for g in want_g),
              f"{kind}: sharded gradients vs one process: {g_err}")
        runs = [r[f"adam_{run}"] for r in rs for run in range(2)]
        losses = runs[0]["losses"]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{kind}: sharded Adam loss did not fall: {losses}")
        check(all(x["losses"] == losses and x["digests"] == runs[0]["digests"]
                  for x in runs),
              f"{kind}: the ranks' or the runs' bits differ after a step")
        launches = [c for x in runs for c in x["launches"]]
        per_step = {k: sorted({c[k] for c in launches})
                    for k in MV_KERNELS[kind]}
        for k in MV_KERNELS[kind]:
            check(per_step[k] == [1],
                  f"{kind}: {k} launched {[c[k] for c in launches]} times "
                  f"per rank per step, not once")
        seg = sorted({c["seg_sum"] for c in launches})
        check(all(x >= 1 for x in seg), f"{kind}: seg_sum not launched")
        st = fresh(_adam)
        adam_ms = median_ms(lambda: step(st, batch), dev)
        out[kind] = {
            "local_views": [r["local_views"] for r in rs],
            "sgd_loss": sgd[0]["loss"], "one_process_loss": want_loss,
            "loss_rel_err": loss_rel, "param_max_abs_err": p_err,
            "grad_rel_err": g_err, "adam_losses": losses,
            "launches_per_rank_step": per_step,
            "seg_sum_per_rank_step": seg,
            "sharded_step_ms": [r["step_ms"] for r in rs],
            "collective_ms": [r["collective_ms"] for r in rs],
            "collective_values": rs[0]["collective_values"],
            "one_process_b2_step_ms": adam_ms}
        o = out[kind]
        log(f"multi-view {kind} ({MV_CFG['ranks']} ranks on "
            f"{o['local_views']} local views each, {out['backend']}, devices "
            f"{out['devices']}): SGD step loss {o['sgd_loss']:.9g} vs one "
            f"process's B={MV_CFG[kind]['n_views']} {want_loss:.9g} (rel "
            f"{loss_rel:.3g}, tol {MV_LOSS_RTOL[kind]}); parameters max abs "
            f"err {p_err:.3g} (rtol 2e-5, atol 1e-7); gradients rel "
            f"{g_err:.3g} (tol {GRAD_RTOL}); Adam losses "
            + ", ".join(f"{x:.6f}" for x in losses)
            + f"; both ranks bitwise equal after every step, and a second "
              f"run equal to the first; per rank per step "
              + ", ".join(f"{k} {v}" for k, v in per_step.items())
            + f", seg_sum {seg}")
        log(f"multi-view {kind} timing (two ranks sharing one card: not a "
            f"scaling number): sharded Adam step {o['sharded_step_ms']} ms "
            f"(median of {MV_TIMED} after {MV_WARMUP}, per rank), of which "
            f"the all-reduce of {o['collective_values']} f32 values alone "
            f"{o['collective_ms']} ms (through the host, gloo); one "
            f"process's B={MV_CFG[kind]['n_views']} Adam step "
            f"{adam_ms:.3f} ms")
    log(f"multi-view: the ranks' run took {spawn_s:.1f} s: {start_s:.1f} s "
        f"until both ranks ran (process start, imports), {work_s:.1f} s of "
        f"both renderers' phases")
    return out


def checkpoint_phases(dev):
    """Phase 24: checkpoint/resume at the tri headline (B=1) and the tet
    headline: 2 Adam steps, save, restore into a fresh state, 2 more steps,
    bitwise equal to 4 uninterrupted steps."""
    from dmesh_renderer_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)

    cfg = {"tri": {**HEADLINE}, "tet": {**TET_HEADLINE, "ray_seed": 0}}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("tri", "tet"):
            fresh, make_step, batch = mv_problem(kind, cfg, dev)
            step = make_step(None)
            # both steps are captured on the card: a capturable optimiser
            adam = _adam_capturable
            st, want = fresh(adam), []
            for _ in range(4):
                st, loss = step(st, batch)
                want.append(float(loss))
            part, got = fresh(adam), []
            for _ in range(2):
                part, loss = step(part, batch)
                got.append(float(loss))
            t0 = time.perf_counter()
            path = save_checkpoint(f"{tmp}/{kind}.pt", part)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            resumed = restore_checkpoint(path, fresh(adam))
            restore_s = time.perf_counter() - t0
            for _ in range(2):
                resumed, loss = step(resumed, batch)
                got.append(float(loss))
            sync(dev)
            check(got == want and digest(resumed.scene) == digest(st.scene),
                  f"{kind}: resumed run {got} differs from the "
                  f"uninterrupted one {want}")
            out[kind] = {"losses": want, "bytes": os.path.getsize(path),
                         "save_s": save_s, "restore_s": restore_s}
            log(f"checkpoint/resume at the {kind} headline: 2 Adam steps, "
                f"save ({out[kind]['bytes']} bytes, {save_s:.3f} s), restore "
                f"into a fresh state ({restore_s:.3f} s), 2 more: losses "
                f"{got} and parameters bitwise equal to 4 uninterrupted "
                f"steps")
    return out


def example_phases():
    """Phase 25: both example loops on the card, each on 2 ranks sharing
    it: the loss falls, and the step resumed from the midpoint
    checkpoint repeats the uninterrupted run's."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    import port_optimize_tet
    import port_optimize_triangles

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # both on 2 ranks: the tri example's 48 triangles take the binned
        # path on the card (BINNED_THRESHOLD_GPU), not the dense oracle's
        # Python loop over the faces
        for name, mod, ranks, steps in (
                ("triangles", port_optimize_triangles, 2, 60),
                ("tet", port_optimize_tet, 2, 60)):
            t0 = time.perf_counter()
            r = mod.main(["--device", "cuda", "--ranks", str(ranks),
                          "--steps", str(steps), "--out-dir", tmp])
            secs = time.perf_counter() - t0
            losses = r["losses"]
            mid = len(losses) // 2 + 1
            check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                  f"example {name}: the loss did not fall: {losses}")
            check(r["resumed_loss"] == losses[mid],
                  f"example {name}: resumed step {r['resumed_loss']} != "
                  f"{losses[mid]}")
            out[name] = {"ranks": ranks, "steps": len(losses),
                         "first_loss": losses[0], "last_loss": losses[-1],
                         "seconds": secs}
            log(f"example port_optimize_{name} on the card, {ranks} rank(s): "
                f"loss {losses[0]:.6f} -> {losses[-1]:.6f} in {len(losses)} "
                f"steps; resumed step equal to the uninterrupted one; "
                f"{secs:.1f} s")
    return out


TRI_GRAPH_KERNELS = ("tri_fwd_composite", "tri_bwd_composite", "seg_sum")


def step_capture_phases(dev):
    """Phase 28: the tri frame and the tri train step as CUDA graphs, at
    the headline and the small scene (module docstring), then
    ``tools.tri_step_ms`` at the headline. Returns the numbers."""
    import dmesh_renderer_tpu_torch as port
    from dmesh_renderer_tpu_torch.models import dmesh
    from dmesh_renderer_tpu_torch.tools import tri_step_ms

    counters = launch_counters()
    out = {}
    for label, cfg in (("headline", HEADLINE), ("small", SMALL)):
        user, fargs, bg = scene_tensors(**cfg, dev=dev)
        H, W, B = cfg["height"], cfg["width"], cfg["n_views"]
        zeros = torch.zeros(3, device=dev)
        batch = dmesh.ViewBatch(*fargs[4:10],
                                torch.zeros((B, 3, H, W), device=dev))

        def fresh():
            scene = dmesh.TriScene(*(fargs[i].detach().clone()
                                     .requires_grad_(True) for i in (0, 2, 3)))
            return dmesh.init_train_state(scene, _adam_capturable)

        eager = dmesh.make_train_step(fargs[1], zeros, H, W, capture=False)
        graphed = dmesh.make_train_step(fargs[1], zeros, H, W)
        se, sg, want, got = fresh(), fresh(), [], []
        for i in range(5):
            se, loss = eager(se, batch)
            want.append(loss)
            if i == 1:  # the capture: counts set to 0 just before
                for w in counters.values():
                    w.launches = 0
            sg, loss = graphed(sg, batch)
            if i == 1:
                sync(dev)
                captured = {k: counters[k].launches
                            for k in TRI_GRAPH_KERNELS}
            got.append(loss)
        loop = dmesh.make_train_loop(fargs[1], zeros, H, W, 5)
        sl, losses = loop(fresh(), batch)
        sync(dev)
        check(all(torch.equal(a, b) for a, b in zip(want, got))
              and digest(sg.scene) == digest(se.scene),
              f"{label}: the captured steps differ from eager ones")
        check(torch.equal(losses, torch.stack(want))
              and digest(sl.scene) == digest(se.scene),
              f"{label}: the captured loop differs from eager steps")
        check((graphed.captures, graphed.replays) == (1, 4)
              and (loop.step.captures, loop.step.replays) == (1, 4),
              f"{label}: captures and replays")
        check(all(captured[k] >= 1 for k in TRI_GRAPH_KERNELS),
              f"{label}: a kernel was not captured: {captured}")
        check(float(want[-1]) < float(want[0]),
              f"{label}: the loss did not fall: {want}")
        r = port.TriRenderer(port.TriRenderSettings(H, W, bg), "cuda")
        frame = r(*user, return_aux=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            frame_g = r(*user, return_aux=True)
        graph.replay()
        sync(dev)
        check(all(torch.equal(a, b) for a, b in zip(
            (*frame[:2], *frame[2]), (*frame_g[:2], *frame_g[2]))),
            f"{label}: the captured serving frame differs from the eager one")
        out[label] = {"losses": [float(x) for x in want],
                      "launches_per_capture": captured,
                      "replays": graphed.replays + loop.step.replays}
        log(f"step capture [{label}]: 5 captured steps and a 5-step loop "
            f"bitwise equal to 5 eager steps (capturable Adam), losses "
            f"{out[label]['losses']}; one capture launched {captured} "
            f"through the wrappers, replayed {out[label]['replays']} times "
            f"(the kernels replay without the wrappers); the captured "
            f"serving frame bitwise equal to the eager one")
    t0 = time.perf_counter()
    m = tri_step_ms.run(str(Path(__file__).resolve().parent), 20, 20,
                        HEADLINE["n_tris"], HEADLINE["height"])
    for k in ("serve_eager", "step_eager"):
        check(m[k]["host_syncs"] <= 1,
              f"{k}: {m[k]['host_syncs']} host syncs, at most 1")
    for k in ("serve_captured", "step_captured"):
        check(m[k]["host_syncs"] == 0,
              f"{k}: {m[k]['host_syncs']} host syncs under replay")
    out["tri_step_ms"] = m
    log(f"tools.tri_step_ms at the headline ({time.perf_counter() - t0:.1f} "
        f"s): {json.dumps(m)}")
    for k in ("serve_eager", "serve_captured", "step_eager", "step_captured"):
        x = m[k]
        log(f"  {k}: {x['ms']:.3f} ms, {x['host_syncs']} host syncs, "
            f"{x['device_events']} device events, busy {x['busy_ms']:.3f} ms "
            f"(share {x['busy_share']:.3f}), peak {x['peak_mib']:.1f} MiB")
    log(f"  make_train_loop: {m['loop_ms_per_step']:.3f} ms per step at "
        f"{m['loop_steps']} steps; stages {m['stages']}")
    return out


TET_GRAPH_KERNELS = ("tet_first_hit", "tet_fwd_march", "tet_bwd_march",
                     "seg_sum")


def tet_capture_phases(dev):
    """Phase 29: the tet frame and the tet train step as CUDA graphs, at
    the tet headline and the tet small scene, a forced record overflow
    under capture at the small scene, then ``tools.tet_step_ms`` at the
    headline (module docstring). Returns the numbers."""
    import dmesh_renderer_tpu_torch as port
    from dmesh_renderer_tpu_torch.models import dmesh
    from dmesh_renderer_tpu_torch.ops import tet as pt
    from dmesh_renderer_tpu_torch.tools import tet_step_ms

    counters = launch_counters()
    n_s, jit_s, gs_s, b_s, h_s, w_s, seed_s = TET_SMALL
    cases = (("headline", (TET_HEADLINE["n_grid"], 1, 0.15, 2),
              TET_HEADLINE["height"], TET_HEADLINE["width"], 0),
             ("small", (n_s, b_s, jit_s, gs_s), h_s, w_s, seed_s))
    out = {}
    for label, scene_args, H, W, seed in cases:
        user, fargs, bg = tet_user(*scene_args, dev)
        B = fargs[4].shape[0]
        zeros = torch.zeros(3, device=dev)
        geom = dmesh.TetGeometry(fargs[0], fargs[1], *fargs[9:12])
        batch = dmesh.TetViewBatch(*fargs[4:9],
                                   torch.zeros((B, 3, H, W), device=dev))

        def fresh():
            scene = dmesh.TetScene(*(fargs[i].detach().clone()
                                     .requires_grad_(True) for i in (2, 3)))
            return dmesh.init_tet_train_state(scene, _adam_capturable)

        def steps(n, **kw):
            """n steps; the launch counts of step 2, the capture (set to
            0 just before it)."""
            step = dmesh.make_tet_train_step(geom, zeros, H, W, seed=seed,
                                             **kw)
            st, losses, grads = fresh(), [], []
            for i in range(n):
                if i == 1:
                    for w in counters.values():
                        w.launches = 0
                st, loss = step(st, batch)
                if i == 1:
                    sync(dev)
                    launched = {k: counters[k].launches
                                for k in TET_GRAPH_KERNELS}
                losses.append(loss)
                grads.append([p.grad.clone() for p in st.scene])
            return step, st, losses, grads, launched

        _e, se, want, want_g, _l = steps(5, capture=False)
        graphed, sg, got, got_g, captured = steps(5)
        loop = dmesh.make_tet_train_loop(geom, zeros, H, W, 5, seed=seed)
        sl, losses = loop(fresh(), batch)
        sync(dev)
        check(all(torch.equal(a, b) for a, b in zip(want, got))
              and all(torch.equal(a, b) for x, y in zip(want_g, got_g)
                      for a, b in zip(x, y))
              and digest(sg.scene) == digest(se.scene),
              f"tet {label}: the captured steps differ from eager ones")
        check(torch.equal(losses, torch.stack(want))
              and digest(sl.scene) == digest(se.scene),
              f"tet {label}: the captured loop differs from eager steps")
        check((graphed.captures, graphed.replays, graphed.fallbacks)
              == (1, 4, 0) and (loop.step.captures, loop.step.replays)
              == (1, 4), f"tet {label}: captures, replays and fallbacks")
        check(all(captured[k] == 1 for k in TET_GRAPH_KERNELS[:3])
              and captured["seg_sum"] == 2,
              f"tet {label}: the capture's launches {captured}")
        check(float(want[-1]) < float(want[0]),
              f"tet {label}: the loss did not fall: {want}")
        r = port.TetRenderer(port.TetRenderSettings(H, W, bg), "cuda")
        frame = r(*user, return_aux=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            frame_g = r(*user, return_aux=True)
        graph.replay()
        sync(dev)
        check(all(torch.equal(a, b) for a, b in zip(
            (*frame[:3], *frame[3]), (*frame_g[:3], *frame_g[3]))),
            f"tet {label}: the captured serving frame differs from the "
            "eager one")
        out[label] = {"losses": [float(x) for x in want],
                      "launches_per_capture": captured,
                      "replays": graphed.replays + loop.step.replays,
                      "record_capacity": pt.record_capacity(B, H, W, 512)}
        log(f"tet step capture [{label}]: 5 captured steps (G1, one flag "
            f"read, G2) and a 5-step loop bitwise equal to 5 eager steps "
            f"(capturable Adam, ray seed {seed}), losses "
            f"{out[label]['losses']}; one capture launched {captured} "
            f"through the wrappers, replayed {out[label]['replays']} times; "
            f"the captured serving frame bitwise equal to the eager one")
        del graphed, loop, graph, frame_g, sg, sl
        if label == "small":
            # the record capacity at one record a ray: every replayed G1
            # flags an overflow and the step takes the exact fallback
            saved_cap = pt.LOG_CAP
            pt.LOG_CAP = 1
            try:
                _e, se1, want1, _g, _l = steps(4, capture=False)
                forced, sf, got1, _g, _l = steps(4)
                sync(dev)
            finally:
                pt.LOG_CAP = saved_cap
            check(all(torch.equal(a, b) for a, b in zip(want1, want[:4]))
                  and all(torch.equal(a, b) for a, b in zip(got1, want1))
                  and digest(sf.scene) == digest(se1.scene),
                  "tet small: a forced record overflow under capture "
                  "differs from the eager steps")
            check((forced.captures, forced.replays, forced.fallbacks)
                  == (1, 0, 3), "tet small: the forced overflow's "
                  f"fallbacks {forced.fallbacks}")
            out["forced_overflow_fallbacks"] = forced.fallbacks
            log("tet small, record capacity at one record a ray: 4 steps, "
                "3 of them replays of G1 that flagged the overflow and took "
                "the exact fallback, bitwise equal to eager steps at the "
                "full capacity")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m = tet_step_ms.run(str(Path(__file__).resolve().parent), 20, 20,
                        TET_HEADLINE["n_grid"], TET_HEADLINE["height"])
    for k in ("serve_eager", "step_eager"):
        check(m[k]["host_syncs"] <= 1,
              f"tet {k}: {m[k]['host_syncs']} host syncs, at most 1")
    check(m["serve_captured"]["host_syncs"] == 0,
          f"tet serve_captured: {m['serve_captured']['host_syncs']} host "
          "syncs under replay")
    check(m["step_captured"]["host_syncs"] == 1,
          f"tet step_captured: {m['step_captured']['host_syncs']} host "
          "syncs, not the one flag read")
    out["tet_step_ms"] = m
    log(f"tools.tet_step_ms at the tet headline "
        f"({time.perf_counter() - t0:.1f} s): {json.dumps(m)}")
    for k in ("serve_eager", "serve_captured", "step_eager", "step_captured"):
        x = m[k]
        log(f"  {k}: {x['ms']:.3f} ms, {x['host_syncs']} host syncs, "
            f"{x['device_events']} device events, busy {x['busy_ms']:.3f} ms "
            f"(share {x['busy_share']:.3f}), peak {x['peak_mib']:.1f} MiB")
    log(f"  make_tet_train_loop: {m['loop_ms_per_step']:.3f} ms per step at "
        f"{m['loop_steps']} steps; stages {m['stages']}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_main = time.perf_counter()
    import dmesh_renderer_tpu_torch as port
    from dmesh_renderer_tpu_torch import kernels
    from dmesh_renderer_tpu_torch.models import dmesh
    from dmesh_renderer_tpu_torch.ops import reduce as rd
    from dmesh_renderer_tpu_torch.ops import tri_binned as tb
    from dmesh_renderer_tpu_torch.ops.tri import render_tri_auto

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    logs = kernels.build(extra_flags=["-Xptxas", "-v"])
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(logs) or 'up to date'})")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  {src}: {line.strip()}")
    ptxas = {k: ptxas_usage(logs, k) for k in (
        "tri_fwd_kernel", "tet_first_hit", "tet_fwd_march", "seg_sum",
        "tet_bwd_march", "proto_step")}
    log(f"ptxas: K1 tri_fwd_kernel {ptxas['tri_fwd_kernel']}; K3 "
        f"tet_first_hit {ptxas['tet_first_hit']}; K4 "
        f"tet_fwd_march {ptxas['tet_fwd_march']}; seg_sum "
        f"{ptxas['seg_sum']}; K5 tet_bwd_march {ptxas['tet_bwd_march']}; "
        f"T4 proto_step {ptxas['proto_step']}")

    # ---- K1 against plain: 4096 tris at 256^2, B=2; then the headline
    user_s, fargs_s, _bg = scene_tensors(**SMALL, dev=dev)
    seq_s, st_s, inputs_s = stages(fargs_s, SMALL["height"], SMALL["width"])
    for _n, fn in seq_s[:-1]:
        fn()
    err_small, got_s = compare_kernel(inputs_s(), "4096 tris, 256x256, B=2")

    H, W = HEADLINE["height"], HEADLINE["width"]
    user, fargs, bg = scene_tensors(**HEADLINE, dev=dev)
    seq, st, inputs = stages(fargs, H, W)
    for _n, fn in seq[:-1]:
        fn()
    err_head, got = compare_kernel(inputs(), "headline")
    k1_ms = cuda_ms(lambda: tb.fwd_composite(*inputs()), 2, 10)
    k1_dev_ms = profiled_device_ms(lambda: tb.fwd_composite(*inputs()),
                                   "tri_fwd_kernel")
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    plain_ms = cuda_ms(lambda: tb.fwd_composite_plain(*inputs()), 0, 2)
    plain_peak = torch.cuda.max_memory_allocated() - base_mem
    log(f"K1 at headline: {k1_ms:.4f} ms (device {k1_dev_ms:.4f}); plain "
        f"version {plain_ms:.2f} ms (peak extra memory "
        f"{plain_peak / 2**20:.1f} MiB)")

    # ---- the bound of K1 on this run's data
    visits, hits, k1_shapes = needed_work(inputs(), got)
    keys = st["keys"]
    n_live = int(keys.ends[-1])  # the live slots of the static table
    n_pix = H * W * HEADLINE["n_views"]
    nbytes = (keys.starts.numel() * 8 + n_live * 4
              + st["ff"].numel() * 4 + st["fi"].numel() * 4
              + n_pix * 12 + n_pix * (6 * 4 + 4))
    bound_ms, bound_by, ops_ms, bytes_ms = bound(
        visits * OPS_PER_VISIT + hits * OPS_PER_HIT, nbytes)
    log(f"K1 work: {visits} visits, {hits} blended-candidate visits -> "
        f"{ops_ms:.4f} ms; {nbytes} bytes -> {bytes_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by}")
    rs, occ = k1_shapes["rows_staged"], k1_shapes["blend_lane_occupancy"]
    log(f"K1 shapes at the headline ({n_live} slots in "
        f"{keys.starts.numel()} tile lists): face rows staged, quarter "
        f"blocks with 256-slot rounds {rs['quarter_blocks_256_slot_rounds']}"
        f", tile blocks with 32-slot rounds "
        f"{rs['tile_blocks_32_slot_rounds']}; the blend's lane occupancy, "
        f"16x2-pixel warps {occ['quarter_blocks_16x2_warps']:.4f}, 8x4 "
        f"warps over each lane's own covered slots "
        f"{occ['tile_blocks_own_covered_slots']:.4f}, pairs packed across "
        f"lanes {occ['tile_blocks_packed_across_lanes']:.4f} (warp-steps "
        f"{k1_shapes['blend_warp_steps']})")

    # ---- the serving path: TriRenderer on the card at the headline scene
    settings = port.TriRenderSettings(H, W, bg)
    renderer = port.TriRenderer(settings, device="cuda")
    tb.fwd_composite.launches = 0
    tb.bwd_composite.launches = 0
    rd.seg_sum.launches = 0
    color, depth, (ovf, n_rendered) = renderer(*user, return_aux=True)
    torch.cuda.synchronize()
    fwd_launches = tb.fwd_composite.launches
    check(fwd_launches >= 1, "serving path did not run K1")
    check(tb.bwd_composite.launches == 0 and rd.seg_sum.launches == 0,
          "serving path ran a backward kernel")
    check(color.grad_fn is None, "serving path recorded a graph")
    check(color.shape == (1, 3, H, W) and depth.shape == (1, 1, H, W),
          "output shapes")
    check(bool(torch.isfinite(color).all() and torch.isfinite(depth).all()),
          "non-finite output")
    check(float(color.min()) >= 0.0 and float(color.max()) <= 1.0 + 1e-5,
          "colour out of range")
    check(float(depth.min()) >= -1.0 - 1e-5 and
          float(depth.max()) <= 1.0 + 1e-5, "depth out of range")
    check(not bool(ovf), "key capacity overflow at the headline")
    check(int(n_rendered) == HEADLINE_PAIRS,
          f"num_rendered {int(n_rendered)} != {HEADLINE_PAIRS}")
    covered = float((depth < 1.0 - 1e-6).float().mean())
    log(f"serving path: num_rendered {int(n_rendered)}, overflow "
        f"{bool(ovf)}, covered pixels {covered:.4f}, K1 launches "
        f"{fwd_launches}")
    seq[-1][1]()
    check(torch.equal(st["out"][0], color) and
          torch.equal(st["out"][1], depth),
          "staged pipeline differs from TriRenderer")

    fwd_ms = cuda_ms(lambda: renderer(*user), 2, 10)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    renderer(*user)
    torch.cuda.synchronize()
    fwd_peak = torch.cuda.max_memory_allocated() - base_mem
    split = {}
    for n, fn in seq:
        split[n] = cuda_ms(fn, 1, 5)
    log(f"forward: {fwd_ms:.3f} ms/frame (peak extra memory "
        f"{fwd_peak / 2**20:.1f} MiB); stage split (ms): "
        + ", ".join(f"{n} {v:.3f}" for n, v in split.items()))

    # ---- the forward's edge cases on the card
    r_small = port.TriRenderer(port.TriRenderSettings(64, 48, bg), "cuda")
    u = user
    c, d = r_small(u[0], u[1][:0], u[2], u[3][:0], u[4], u[5], u[6],
                   u[7][:, :0])
    check(bool((c == bg[None, :, None, None]).all() and (d == 1).all()),
          "F==0 must give bg and depth 1")
    c, d = r_small(u[0][:0], u[1][:0], u[2][:0], u[3][:0], u[4], u[5],
                   u[6][:, :0], u[7][:, :0])
    check(not bool(c.any() or d.any()), "P==0 must give zeros")
    u2, _f2, _bg2 = scene_tensors(**TWO, dev=dev)
    HS, WS = SMALL["height"], SMALL["width"]
    H2, W2 = TWO["height"], TWO["width"]
    before = tb.fwd_composite.launches
    c, d = port.TriRenderer(port.TriRenderSettings(H2, W2, bg), "cuda")(*u2)
    torch.cuda.synchronize()
    check(tb.fwd_composite.launches == before + 1, "B=2 did not run K1")
    check(c.shape == (2, 3, H2, W2) and bool(torch.isfinite(c).all()
                                               and torch.isfinite(d).all()),
          "B=2 outputs")
    cb, db = render_tri_auto(*fargs_s, HS, WS, force="binned")
    co, do = render_tri_auto(*fargs_s, HS, WS, force="oracle")
    e_or = max(float((cb - co).abs().max()), float((db - do).abs().max()))
    check(e_or <= 2e-5, f"binned vs oracle on the card: {e_or}")
    log(f"edge cases: F==0, P==0, B=2 800x800 20k tris ok; binned vs dense "
        f"oracle at 4096 tris: max_abs_err {e_or:.3g} (tol 2e-5)")

    # ---- K2 against plain: 4096 tris at 256^2, B=2; then the headline
    k2_err_s, _rec_s, _gin_s, _wk_s = compare_k2(
        inputs_s(), got_s, fargs_s[1], fargs_s[9], fargs_s[0].shape[0],
        st_s["keys"].sigma, "4096 tris, 256x256, B=2", seed=1)
    k2_err_h, (rec, rec_ids), gin, wk = compare_k2(
        inputs(), got, fargs[1], fargs[9], fargs[0].shape[0], keys.sigma,
        "headline", seed=0)
    state = got[2:]
    k2_call = lambda: tb.bwd_composite(*inputs()[:6], *state, gin, 1, H, W)
    k2_ms = cuda_ms(k2_call, 2, 10)
    k2_dev_ms = profiled_device_ms(k2_call, "tri_bwd_kernel")
    k2_plain_ms = cuda_ms(
        lambda: tb.bwd_composite_plain(*inputs()[:6], *state, gin, 1, H, W),
        0, 1)
    b_visits, b_active, b_live, b_rows, b_pairs = bwd_work(inputs(), state[2])
    check(b_rows == wk, f"K2 wrote {wk} rows, the tiles walk {b_rows} slots")
    rec_bytes = wk * 4 * tb.REC_COLS * 4
    # tile ranges and walked offsets, the walked face rows, per pixel the
    # ray (12), K1's state (12) and gin (20); the output is the compacted
    # buffer, written once: every walked (slot, quarter) row (zeros for
    # those no pixel blended) and each row's slot id
    b_bytes = (keys.starts.numel() * 12 + b_rows * FACE_ROW_BYTES
               + n_pix * (12 + 12 + 20) + rec_bytes + b_rows * 4)
    k2_bound, k2_by, k2_ops_ms, k2_bytes_ms = bound(
        b_visits * OPS_PER_VISIT + b_active * OPS_PER_BWD_ACTIVE
        + b_live * OPS_PER_LIVE_SLOT, b_bytes)
    S_slots = n_live
    log(f"K2 at headline: {k2_ms:.4f} ms (device {k2_dev_ms:.4f}); plain "
        f"version {k2_plain_ms:.2f} ms. Walked: {b_rows} of {S_slots} slots "
        f"({b_rows * 4} record rows, {rec_bytes} bytes written, against "
        f"{S_slots * 4 * tb.REC_COLS * 4} for the full layout, in a buffer "
        f"of {rec.numel() * 4} bytes at the slot capacity), {b_pairs} "
        f"walked (slot, quarter) pairs, {b_live} live. Work: {b_visits} "
        f"visits, {b_active} active -> {k2_ops_ms:.4f} ms; {b_bytes} bytes "
        f"-> {k2_bytes_ms:.4f} ms; bound {k2_bound:.4f} ms by {k2_by}")

    # ---- seg_sum against plain, bit for bit, at both of the main path's
    # shapes: the headline's record reduce (the compacted records) and its
    # vertex reduce
    F = fargs[1].shape[0]
    # the walked rows (the main path's CSR also holds the sentinel rows past
    # them, which seg_sum never reads)
    csr = rd.segment_csr(tb.record_segments(rec_ids[:wk], keys.slot_face, F),
                         F, inner=4)
    vals = rec[:wk].reshape(-1, tb.REC_COLS)
    _gop, g_p, g_vc, g_vd, _gint = tb.records_to_faces(
        rec, rec_ids, keys.slot_face, keys.sigma, inputs()[3], fargs[9])
    corners = rd.corner_rows(g_p, g_vc, g_vd)
    csr_v = rd.segment_csr(fargs[1], fargs[0].shape[0])
    ss_err = 0.0
    for label, x, c in (("record reduce", vals, csr),
                        ("vertex reduce", corners, csr_v)):
        before = rd.seg_sum.launches
        s_k = rd.seg_sum(x, c)
        torch.cuda.synchronize()
        check(rd.seg_sum.launches == before + 1, "seg_sum did not launch")
        s_p = rd.seg_sum_plain(x, c)
        check(bool(s_p.any()), f"seg_sum {label}: all zero")
        ss_err = max(ss_err, float((s_k - s_p).abs().max()))
        check(torch.equal(s_k, s_p),
              f"seg_sum differs from its plain version at the {label}")
        log(f"seg_sum vs plain at the headline {label} ({tuple(x.shape)} -> "
            f"{tuple(s_k.shape)}): bitwise equal")
    ss_plain_ms = cuda_ms(lambda: rd.seg_sum_plain(vals, csr), 0, 1)
    tri_rec = time_seg_sum(vals, csr, "headline record reduce")
    tri_vtx = time_seg_sum(corners, csr_v, "headline vertex reduce")
    ss_ms, ss_lib_ms, ss_bound, ss_by = (tri_rec[k] for k in (
        "ms", "library_ms", "bound_ms", "bound_by"))
    N, C = vals.shape
    log(f"seg_sum at the headline record reduce: {ss_ms:.4f} ms against "
        f"torch.segment_reduce {ss_lib_ms:.4f} ms in this run (faster: "
        f"{ss_ms < ss_lib_ms}); reads {N * C * 4} record bytes; plain "
        f"{ss_plain_ms:.2f} ms. Vertex reduce: {tri_vtx['ms']:.4f} ms per "
        f"call against torch.segment_reduce {tri_vtx['library_ms']:.4f} "
        f"(no slower: {tri_vtx['ms'] <= tri_vtx['library_ms']})")

    # ---- the training path: TriRenderer with gradients at the headline
    leaves = leaves_of(user)

    def fwd_bwd():
        for x in leaves:
            x.grad = None
        c, d = renderer(leaves[0], user[1], leaves[1], leaves[2], user[4],
                        user[5], leaves[3], leaves[4])
        (c.sum() + d.sum()).backward()

    tb.fwd_composite.launches = 0
    tb.bwd_composite.launches = 0
    rd.seg_sum.launches = 0
    fwd_bwd()
    torch.cuda.synchronize()
    launches = {"tri_fwd_composite": tb.fwd_composite.launches,
                "tri_bwd_composite": tb.bwd_composite.launches,
                "seg_sum": rd.seg_sum.launches}
    for k, v in launches.items():
        check(v >= 1, f"training path did not run {k}")
    g1 = [x.grad.clone() for x in leaves]
    for x, g in zip(leaves, g1):
        check(g.shape == x.shape and bool(torch.isfinite(g).all()),
              "training-path gradients")
    check(all(bool(g.any()) for g in g1), "a gradient is all zero")
    fwd_bwd()
    check(all(torch.equal(x.grad, g) for x, g in zip(leaves, g1)),
          "headline gradients differ between two runs")
    log(f"training path: launches {launches}; five gradients finite, "
        f"bitwise equal across two runs")
    fb_ms = cuda_ms(fwd_bwd, 2, 10)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    fwd_bwd()
    torch.cuda.synchronize()
    fb_peak = torch.cuda.max_memory_allocated() - base_mem

    def fwd_only():
        c, d = renderer(leaves[0], user[1], leaves[1], leaves[2], user[4],
                        user[5], leaves[3], leaves[4])
        return c, d

    ones_gin = tb.upstream_planes(torch.ones(1, 3, H, W, device=dev),
                                  torch.ones(1, 1, H, W, device=dev), bg)
    rec1, ids1 = tb.bwd_composite(*inputs()[:6], *state, ones_gin, 1, H, W)
    faces_t = fargs[1]
    fb_split = {
        "forward": cuda_ms(fwd_only, 2, 10),
        "K2": cuda_ms(lambda: tb.bwd_composite(*inputs()[:6], *state,
                                                ones_gin, 1, H, W), 2, 10),
        "record reduce": cuda_ms(lambda: tb.records_to_faces(
            rec1, ids1, keys.slot_face, keys.sigma, inputs()[3], fargs[9]),
            2, 10),
    }
    gf = tb.records_to_faces(rec1, ids1, keys.slot_face, keys.sigma,
                             inputs()[3], fargs[9])
    fb_split["vertex reduce"] = cuda_ms(lambda: rd.faces_to_verts(
        faces_t, fargs[0].shape[0], gf[1], gf[2], gf[3]), 2, 10)
    fb_split["rest"] = fb_ms - sum(fb_split.values())
    fwd_nograd_ms = cuda_ms(lambda: renderer(*user), 2, 10)
    log(f"fwd+bwd: {fb_ms:.3f} ms/frame (peak extra memory "
        f"{fb_peak / 2**20:.1f} MiB); split (ms): "
        + ", ".join(f"{n} {v:.3f}" for n, v in fb_split.items())
        + f"; the forward without gradients, timed next: "
          f"{fwd_nograd_ms:.3f} ms")

    # ---- binned against the oracle on the card, five gradients, 4096 tris
    wgen = torch.Generator().manual_seed(3)
    wc = torch.randn((2, 3, HS, WS), generator=wgen).to(dev)
    wd = torch.randn((2, 1, HS, WS), generator=wgen).to(dev)

    def grads(force):
        lv = leaves_of(user_s)
        c, d = render_tri_auto(lv[0], fargs_s[1], lv[1], lv[2],
                               *fargs_s[4:8], lv[3], lv[4], fargs_s[10],
                               HS, WS, force=force)
        ((c * wc).sum() + (d * wd).sum()).backward()
        return [x.grad for x in lv]

    e_bo = max(rel(a, b) for a, b in zip(grads("binned"), grads("oracle")))
    check(e_bo <= GRAD_RTOL, f"binned vs oracle gradients: {e_bo}")
    for sel in ("F==0", "P==0"):
        v, vc, fo, vd, fi = (u[i] for i in (0, 2, 3, 6, 7))
        fo, fi = fo[:0], fi[:, :0]
        if sel == "P==0":
            v, vc, vd = v[:0], vc[:0], vd[:, :0]
        lv = [x.clone().requires_grad_(True) for x in (v, vc, fo, vd, fi)]
        c, d = r_small(lv[0], u[1][:0], lv[1], lv[2], u[4], u[5], lv[3],
                       lv[4])
        (c.sum() + d.sum()).backward()
        check(all(x.grad is not None and x.grad.shape == x.shape
                  and not bool(x.grad.any()) for x in lv),
              f"{sel}: gradients must be zeros")
    log(f"binned vs oracle on the card, five gradients at 4096 tris: rel "
        f"err {e_bo:.3g} (tol {GRAD_RTOL}); F==0 and P==0 give zero "
        f"gradients")

    # ---- make_train_step with Adam(1e-2, capturable) at the headline: the
    # first step eager, the second captured and replayed, then replays
    lv = leaves_of(user)
    scene = dmesh.TriScene(lv[0], lv[1], lv[2])
    batch = dmesh.ViewBatch(fargs[4], fargs[5], fargs[6], fargs[7], fargs[8],
                            fargs[9], torch.zeros(1, 3, H, W, device=dev))
    train_state = dmesh.init_train_state(scene, _adam_capturable)
    step = dmesh.make_train_step(fargs[1], torch.zeros(3, device=dev), H, W)
    losses, step_times = [], []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        train_state, loss = step(train_state, batch)
        e1.record()
        torch.cuda.synchronize()
        step_times.append(e0.elapsed_time(e1))
        losses.append(float(loss))
    check(all(np.isfinite(x) for x in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check((step.captures, step.replays) == (1, 4),
          f"train step: {step.captures} captures, {step.replays} replays")
    step_ms = float(np.mean(step_times[2:]))
    log(f"train step (Adam 1e-2 capturable, zero target): losses "
        + ", ".join(f"{x:.6f}" for x in losses))
    log(f"timing: fwd+bwd {fb_ms:.3f} ms/frame; train step {step_ms:.3f} "
        f"ms/step (mean of the replays, steps 3-5; step 1, eager, "
        f"{step_times[0]:.3f} ms; step 2, capture and replay, "
        f"{step_times[1]:.3f} ms)")

    # ---- B=2 with gradients: per-view depth and intensity gradients
    lv2 = leaves_of(u2)
    before = tb.bwd_composite.launches
    c, d = port.TriRenderer(port.TriRenderSettings(H2, W2, bg), "cuda")(
        lv2[0], u2[1], lv2[1], lv2[2], u2[4], u2[5], lv2[3], lv2[4])
    (c.sum() + d.sum()).backward()
    torch.cuda.synchronize()
    check(tb.bwd_composite.launches == before + 1, "B=2 did not run K2")
    check(all(bool(torch.isfinite(x.grad).all()) for x in lv2),
          "B=2 gradients not finite")
    check(all(bool(lv2[i].grad[b].any()) for i in (3, 4) for b in (0, 1)),
          "B=2: a view's depth or intensity gradient is all zero")
    log("B=2 800x800 20k tris with gradients: finite, per-view depth and "
        "intensity gradients nonzero in both views")

    tet_kernels, tet_info, tet_head = tet_phases(dev)
    k5_entry, tet_train_info = tet_train_phases(dev, tet_head)
    k5_entry["ptxas"] = ptxas["tet_bwd_march"]
    tet_kernels[0]["ptxas"] = ptxas["tet_first_hit"]
    tet_kernels[1]["ptxas"] = ptxas["tet_fwd_march"]
    answers, probe_launches = tools_main_path(dev)
    probe_entries = probe_kernel_phases(dev, answers, probe_launches)
    probe_entries[3]["ptxas"] = ptxas["proto_step"]
    split_us = launch_path_split(dev)
    tet_head["tri_user"] = user
    diag = diagnostics_phases(dev, fargs, tet_head)
    t_new = time.perf_counter()
    multi_view = multi_view_phases(dev)
    ckpt = checkpoint_phases(dev)
    examples = example_phases()
    log(f"phases 23-25 took {time.perf_counter() - t_new:.1f} s; the script "
        f"{time.perf_counter() - t_main:.1f} s until here")
    t_new = time.perf_counter()
    fuzz = fuzz_phases(dev)
    ladder = dispatch_ladder(dev)
    log(f"phases 26-27 (fuzz sweeps, dispatch ladder) took "
        f"{time.perf_counter() - t_new:.1f} s; the script "
        f"{time.perf_counter() - t_main:.1f} s until here")
    t_new = time.perf_counter()
    graphs = step_capture_phases(dev)
    log(f"phase 28 (step capture) took {time.perf_counter() - t_new:.1f} s; "
        f"the script {time.perf_counter() - t_main:.1f} s until here")
    graph_launches = {k: {"per_capture": graphs["headline"][
        "launches_per_capture"][k], "replays": graphs["headline"]["replays"]}
        for k in TRI_GRAPH_KERNELS}
    t_new = time.perf_counter()
    tet_graphs = tet_capture_phases(dev)
    log(f"phase 29 (tet step capture) took "
        f"{time.perf_counter() - t_new:.1f} s; the script "
        f"{time.perf_counter() - t_main:.1f} s until here")
    tet_graph_launches = {k: {"per_capture": tet_graphs["headline"][
        "launches_per_capture"][k], "replays": tet_graphs["headline"][
        "replays"]} for k in TET_GRAPH_KERNELS}
    sharded = {k: v for kind in ("tri", "tet")
               for k, v in multi_view[kind]["launches_per_rank_step"].items()}
    for entry in (*tet_kernels, k5_entry):
        entry["launches_sharded_per_rank_step"] = sharded[entry["name"]]
        entry["launches_captured_tet_step"] = tet_graph_launches[
            entry["name"]]

    common = {"route": "cuda"}
    log(json.dumps({"kernels": [
        {**common, "name": "tri_fwd_composite",
         "source": "dmesh_renderer_tpu_torch/csrc/tri_fwd.cu",
         "replaces": "dmesh_renderer_tpu/ops/tri_binned.py:605",
         "launches": launches["tri_fwd_composite"],
         "launches_serving_path": fwd_launches,
         "launches_sharded_per_rank_step": sharded["tri_fwd_composite"],
         "launches_captured_step": graph_launches["tri_fwd_composite"],
         "max_abs_err": max(err_small, err_head),
         "ms": k1_ms, "device_ms": k1_dev_ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
         "bit_equal": bool(err_small == 0.0 and err_head == 0.0),
         **k1_shapes, "ptxas": ptxas["tri_fwd_kernel"],
         "forward_ms": fwd_ms, "forward_split_ms": split,
         "forward_peak_mib": fwd_peak / 2**20,
         "plain_peak_mib": plain_peak / 2**20,
         "num_rendered": int(n_rendered), "visits": visits, "hits": hits},
        {**common, "name": "tri_bwd_composite",
         "source": "dmesh_renderer_tpu_torch/csrc/tri_bwd.cu",
         "replaces": "dmesh_renderer_tpu/ops/tri_binned.py:797",
         "launches": launches["tri_bwd_composite"],
         "launches_sharded_per_rank_step": sharded["tri_bwd_composite"],
         "launches_captured_step": graph_launches["tri_bwd_composite"],
         "max_abs_err": max(k2_err_s, k2_err_h),
         "ms": k2_ms, "device_ms": k2_dev_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "visits": b_visits, "active_visits": b_active,
         "live_slot_quarters": b_live, "walked_slots": b_rows,
         "walked_slot_quarters": b_pairs, "slots": S_slots,
         "slot_capacity": int(keys.slot_face.numel()),
         "record_bytes": rec_bytes,
         "tri_frame_host_syncs": diag["traces"]["tri"]["host_syncs"]},
        {**common, "name": "seg_sum",
         "source": "dmesh_renderer_tpu_torch/csrc/tri_bwd.cu",
         "replaces": "dmesh_renderer_tpu/ops/tri_binned.py:301 "
                     "(_reduce_records, an XLA scatter-add: port glue, "
                     "not a TPU kernel)",
         "launches": launches["seg_sum"],
         "launches_tet_train": tet_train_info["tet_seg_sum_launches"],
         "launches_captured_step": graph_launches["seg_sum"],
         "launches_captured_tet_step": tet_graph_launches["seg_sum"],
         "launches_sharded_per_rank_step": {
             k: multi_view[k]["seg_sum_per_rank_step"]
             for k in ("tri", "tet")},
         "max_abs_err": max(ss_err,
                            tet_train_info["tet_seg_sum_max_abs_err"]),
         "ms": ss_ms, "plain_ms": ss_plain_ms, "bound_ms": ss_bound,
         "bound_by": ss_by, "library_ms": ss_lib_ms,
         "library_gather_ms": tri_rec["library_gather_ms"],
         "shape": [N, C, F], "segments": tri_rec["segments"],
         "tri_vertex_reduce": tri_vtx,
         "tet_record_reduce": tet_train_info["tet_seg_sum_record"],
         "tet_vertex_reduce": tet_train_info["tet_seg_sum_vertex"],
         "ptxas": ptxas["seg_sum"]},
        *tet_kernels, k5_entry, *probe_entries,
    ], "fwd_bwd_ms": fb_ms, "fwd_bwd_split_ms": fb_split,
        "fwd_bwd_peak_mib": fb_peak / 2**20,
        "forward_no_grad_after_ms": fwd_nograd_ms, "train_step_ms": step_ms,
        "train_losses": losses, **tet_info, **tet_train_info,
        "diagnostics": diag, "launch_path_split_us": split_us,
        "multi_view": multi_view, "checkpoint": ckpt, "examples": examples,
        "fuzz": fuzz, "dispatch_ladder": ladder, "step_capture": graphs,
        "tet_step_capture": tet_graphs,
        "experiments": {k: _jsonable(v) for k, v in answers.items()}}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
