"""Drive the torch port's tri renderer and tet renderer, forward and
backward, on one CUDA card and check them.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one) and nvcc. Steps:

1. print the card (name, count, nvidia-smi name and power limit);
2. build the CUDA kernels of dmesh_renderer_tpu_torch/csrc (one nvcc per
   source, all at once) and print the build time and ptxas usage, K5's and
   seg_sum's registers and shared memory on a line of their own;
3. hold the forward compositing kernel (K1, ``fwd_composite``) against its
   plain torch version on the card, at 4096 triangles, 256x256, B=2 and at
   the headline scene (100k triangles, 800x800, B=1, seed 0);
4. drive the serving path, ``TriRenderer`` on the card at the headline
   scene, with the launch counts set to 0 just before and read just after;
   check its outputs, time it (2 warm-up, 10 timed runs, CUDA events) and
   split the time by stage;
5. check the forward's edge cases on the card: no faces, no vertices, B=2
   at 800x800 with 20k triangles, and binned against the dense oracle at
   4096 triangles;
6. hold the backward kernel (K2, ``bwd_composite``) against its plain
   version with a fixed random upstream gradient, records and the five
   gradients, at 4096 triangles/256x256/B=2 and at the headline; time it
   and work out its bound from the run's counts;
7. hold ``seg_sum`` against its plain version bit for bit at both shapes
   the main path gives it (the headline's record reduce and vertex
   reduce), print their segment lengths (mean, p99, max), and time it at
   both beside its bound, ``torch.segment_reduce`` on rows already in CSR
   order and ``index_select`` + ``segment_reduce`` from its own inputs;
8. drive the training path, ``TriRenderer`` on leaf tensors that require
   grad at the headline with the loss sum(color) + sum(depth), then
   ``backward()``, counts set to 0 just before and read just after; check
   the gradients, run it twice (bitwise equal), time it and split it;
9. binned against the oracle on the card, all five gradients at 4096
   triangles; zero gradients of empty geometry;
10. ``models.dmesh.make_train_step`` with Adam(1e-2) at the headline (zero
    target and background), 5 steps: the loss falls;
11. the B=2 scene (20k triangles, 800x800) with gradients;
12. hold the tet first-hit kernel (K3, ``first_hit``) and march kernel (K4,
    ``fwd_march``) against their plain versions at a small scene
    (``freudenthal_grid(6, 0.14, 21)``, 256x256, B=2, ray seed 17) and at
    the tet headline (``freudenthal_grid(20, 0.15, 2)``: 98,400 faces,
    48,000 tets, 800x800, B=1); work out their bounds from the run's counts;
13. drive the tet serving path, ``TetRenderer`` on the card at the tet
    headline, counts set to 0 just before and read just after (K3 and K4
    once each); check the pair count (321,998, no overflow) and the
    first-hit pixels (577,342) exactly, and print the active pixels, the
    longest walk and the blend events beside the JAX package's CPU values;
    time it (2 warm-up, 10 timed runs) and split it by stage;
14. the tet edge cases on the card: the dense first hit (<= 2048 faces)
    against the forced binned one, B=2 at the headline grid, jittered rays
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
17. ``models.dmesh.make_tet_train_step`` with Adam(1e-2) at the tet
    headline (zero target and background), 5 steps: the loss falls;
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
    under the profiler, the plain versions' times with the tools' timer,
    and the bound from the run's counts;
21. ``utils.diagnostics`` at the headlines: ``tri_render_stats`` (770,003
    pairs, no overflow) and ``tet_health`` (577,334 active pixels);
22. a ``diagnostics.trace`` of one tet and one tri training frame, each
    timed by a ``StageTimer``: the device busy share, the device time the
    trace holds over the frame's time;
23. print one JSON line of per-kernel numbers, and as the last line
    ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
TET_DENSE = (5, 0.1, 8, 2, 256, 256, 0)  # 1,950 faces: the dense first hit
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
# 1, accumulators 8, termination 2) and a K4 walk step (4 slots x (normal
# 27, Moller-Trumbore 51, selection 5))
OPS_PER_FH_VISIT = 41
OPS_PER_BLEND = 44
OPS_PER_WALK = 4 * (27 + 51 + 5)
FH_ROW_BYTES = 16 * 4 + 4  # first-hit table row and its slot_face entry
# f32 operations of a K5 visit: barycentric 2, colour 18, depth 9, log T 1,
# exp 1, the four suffix accumulators 16, dL/dalpha 12 and its background
# term 7, the weight 2, the nine colour moments 12, termination 2; a K5
# walk step does K4's but reads the normals: 4 slots x (the normal's dot 5,
# Moller-Trumbore 51, selection 5)
OPS_PER_BWD_VISIT = 82
OPS_PER_BWD_WALK = 4 * (5 + 51 + 5)
# per ray with records, what K5 reads: ray 12, zw 16, start face/tet and
# first face 12, the 11 float rows 44, its slot offset 8; per ray its record
# count 4 and mismatch flag 1; per record the key 4 and 10 values 40
K5_RAY_BYTES = 12 + 16 + 12 + 44 + 8
K5_REC_BYTES = 4 + 10 * 4
# the card's tet gradients against the port's on the CPU, rel Linf: the two
# devices' exp and log differ in the last bits (hazard g)
TET_CARD_CPU_RTOL = 1e-5
# The experiment kernels' shapes (the JAX tools' full sizes): T1's table
# rows and lookup rows (8, the TPU's; 5,000 rows of 128, the march width),
# the rays of T2-T4 and T4's chained steps
PROBE_TABLE_ROWS = (8, 32, 64, 512, 48_000)
PROBE_LOOKUP_ROWS = (8, 5_000)
PROBE_RAYS = 640_000
TET_HEADLINE_ACTIVE = 577_334  # active pixels of the tet headline on the card
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
    calls, and the kernel's own time under the profiler), beside its bytes
    bound (each value, row id and offset read once, each sum written
    once), one ``torch.segment_reduce`` call on rows already in CSR order,
    and ``index_select`` + ``segment_reduce``, which start from the same
    inputs as seg_sum. Returns a dict of the numbers."""
    from dmesh_renderer_tpu_torch.ops import reduce as rd

    N, C = x.shape
    n_seg = csr.offsets.numel() - 1
    data = x.index_select(0, csr.order)
    lib = torch.segment_reduce(data, "sum", offsets=csr.offsets)
    check(rel(lib, rd.seg_sum(x, csr)) <= 1e-5,
          f"segment_reduce disagrees with seg_sum at the {label}")
    ms = cuda_ms(lambda: rd.seg_sum(x, csr), 2, 10)
    lib_ms = cuda_ms(
        lambda: torch.segment_reduce(data, "sum", offsets=csr.offsets), 2, 10)
    gather_ms = cuda_ms(lambda: torch.segment_reduce(
        x.index_select(0, csr.order), "sum", offsets=csr.offsets), 2, 10)
    dev_ms = profiled_device_ms(lambda: rd.seg_sum(x, csr), "seg_sum")
    b_ms, b_by, _o, _b = bound(
        N * C, N * C * 4 + N * csr.order.element_size()
        + csr.offsets.numel() * 8 + n_seg * C * 4)
    seg = seg_lengths(csr)
    log(f"seg_sum at the {label} ({N} x {C} -> {n_seg} x {C}; segment "
        f"lengths mean {seg['mean']:.2f}, p99 {seg['p99']:.0f}, max "
        f"{seg['max']}, empty {seg['empty']}): {ms:.4f} ms (device "
        f"{dev_ms:.4f}); "
        f"torch.segment_reduce on the CSR-ordered rows {lib_ms:.4f} ms, "
        f"index_select + segment_reduce {gather_ms:.4f} ms; bound "
        f"{b_ms:.4f} ms by {b_by}")
    return {"ms": ms, "device_ms": dev_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib_ms, "library_gather_ms": gather_ms,
            "shape": [N, C, n_seg], "segments": seg}


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
    transposed functional args incl. inverses, bg)."""
    from dmesh_renderer_tpu_torch.utils.scenes import tri_scene

    v, f, vc, fo, mv, proj, vd, fi = tri_scene(n_tris, n_views, height,
                                               width, seed)
    user = [torch.from_numpy(x).to(dev) for x in (v, f, vc, fo, mv, proj,
                                                  vd, fi)]
    mv_t = user[4].transpose(1, 2).contiguous()
    proj_t = user[5].transpose(1, 2).contiguous()
    bg = torch.tensor([0.1, 0.1, 0.1], device=dev)
    fargs = (user[0], user[1], user[2], user[3], mv_t, proj_t,
             torch.linalg.inv(mv_t), torch.linalg.inv(proj_t), user[6],
             user[7], bg)
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
    S = slot_face.numel()
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
    """(visits, hits) K1's run needs: per pixel, the slots of its tile up
    to the one that finished it (all of them if none did), and how many of
    those cover the pixel."""
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
    hits = 0
    for _sl, t, cov, pos in _slot_chunks(inputs):
        hits += int((cov & (pos[:, None] < stop[t])).sum())
    return visits, hits


def bwd_work(inputs, nc):
    """What K2's run needs: (visits, active visits, live (slot, quarter)
    pairs, face rows). A pixel tests coverage at every slot below its
    n_contrib; an active visit is a covered one (a ray parallel to its
    face, which the kernel also drops, is not subtracted); a (slot,
    quarter) is live when any of its pixels is active; a tile needs the
    rows of its slots below its largest n_contrib."""
    starts, ends, _sf, _ff, _fi, _rd, B, H, W = inputs
    gx, gy = (W + 31) // 32, (H + 31) // 32
    ncp = _tile_planes(nc.long(), B, H, W, gx, gy, 0)  # [NT, 1024]
    count = (ends - starts).long()
    visits = int(nc.long().sum())
    rows = int(torch.minimum(count, ncp.max(dim=1).values).sum())
    active = live = 0
    for _sl, t, cov, pos in _slot_chunks(inputs):
        act = cov & (pos[:, None] < ncp[t])
        active += int(act.sum())
        live += int(act.reshape(-1, 2, 16, 2, 16).any(dim=(2, 4)).sum())
    return visits, active, live, rows


def bound(ops, nbytes):
    ops_ms, bytes_ms = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes"), ops_ms, bytes_ms


def compare_k2(inputs, k1_out, faces, faces_intense, n_verts, sigma, label,
               seed):
    """K2 against its plain version on the same CUDA inputs and a fixed
    random upstream gradient; then the five gradients reduced from each."""
    from dmesh_renderer_tpu_torch.ops import tri_binned as tb

    B, H, W = inputs[6:]
    g = torch.Generator().manual_seed(seed)
    gin = torch.randn((B, 5, H, W), generator=g).to(inputs[5].device)
    state = k1_out[2:]
    before = tb.bwd_composite.launches
    rec = tb.bwd_composite(*inputs[:6], *state, gin, B, H, W)
    torch.cuda.synchronize()
    check(tb.bwd_composite.launches == before + 1, "K2 did not launch")
    want = tb.bwd_composite_plain(*inputs[:6], *state, gin, B, H, W)
    torch.cuda.synchronize()
    check(bool((want != 0).any()), f"{label}: K2 records all zero")
    e_rec = rel(rec, want)
    check(np.isfinite(e_rec) and e_rec <= K2_RTOL,
          f"{label}: K2 records rel err {e_rec}")
    gk = tb.reduce_records(rec, inputs[2], sigma, inputs[3], faces,
                           faces_intense, n_verts)
    gp = tb.reduce_records(want, inputs[2], sigma, inputs[3], faces,
                           faces_intense, n_verts)
    e_grad = max(rel(a, b) for a, b in zip(gk, gp))
    check(e_grad <= K2_RTOL, f"{label}: K2 gradients rel err {e_grad}")
    log(f"K2 vs plain [{label}]: records rel err {e_rec:.3g}, gradients rel "
        f"err {e_grad:.3g} (tol {K2_RTOL}); records equal "
        f"{torch.equal(rec, want)}")
    return max(float((rec - want).abs().max()), max(
        float((a - b).abs().max()) for a, b in zip(gk, gp))), rec, gin


def leaves_of(user):
    """Fresh leaf copies of the five differentiable user inputs."""
    return [user[i].detach().clone().requires_grad_(True)
            for i in (0, 2, 3, 6, 7)]


def tet_user(n_grid, n_views, jitter, gseed, dev, seed_offset=0):
    """A tet scene as CUDA tensors: (user inputs of TetRenderer, the
    functional args with transposed matrices and inverses, bg)."""
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
             torch.linalg.inv(mv_t), torch.linalg.inv(proj_t), user[7],
             user[8], user[9], user[10], bg)
    return user, fargs, bg


def tet_stages(fargs, h, w, seed=0):
    """The tet forward's stages (the sequence of
    ops.tet.render_tet_forward on its binned path), one function each, so
    that each can be timed; and the inputs of K3 and K4."""
    from dmesh_renderer_tpu_torch.ops import binning, geometry, rays
    from dmesh_renderer_tpu_torch.ops import tet as pt
    from dmesh_renderer_tpu_torch.ops import tet_first_hit as pfh

    (verts, faces, vc, fo, mv_t, proj_t, inv_mv_t, inv_proj_t, fi, tets,
     face_tets, tet_faces, bg) = fargs
    B, F = mv_t.shape[0], faces.shape[0]
    N, M = h * w, mv_t.shape[0] * h * w
    gx, gy = (w + 31) // 32, (h + 31) // 32
    kcap = binning.default_key_capacity(B, F, avg_tiles_per_face=5)
    cam_o = inv_mv_t[:, 3, :3].contiguous()
    st = {}

    def project():
        ndc, img = geometry.project_verts(verts, mv_t, proj_t, w, h)
        st["pre"] = geometry.preprocess_faces(ndc, img, faces, w, h, 32, 32)

    def binning_():
        st["keys"] = binning.emit_and_sort(st["pre"], gx, gy, kcap,
                                           sort_by="min_depth")

    def table():
        st["table"] = pfh.build_first_hit_table(
            verts, faces, cam_o, st["pre"]["min_depth"],
            st["pre"]["max_depth"])[st["keys"].sigma]

    def rays_():
        st["rd"] = rays.generate_rays(inv_mv_t, inv_proj_t, w, h,
                                      norm_eps_mode="tet",
                                      jitter_seed=seed or None)[1]

    def fh_inputs():
        k = st["keys"]
        return (k.starts, k.ends, k.slot_face, st["table"], st["rd"], B, h, w)

    def k3():
        st["fh"] = pfh.first_hit(*fh_inputs())

    def tables():
        st["march"] = m = pt.march_tables(verts, faces, tets, tet_faces,
                                          face_tets, vc, fo, fi)
        st["ff"] = st["fh"][0].reshape(M)
        st["first_tet"] = pt.start_tets(st["ff"], st["rd"].reshape(M, 3),
                                        m["geo"], m["sign"], face_tets,
                                        tet_faces)
        st["zw"] = pt.projective_zw(cam_o, st["rd"].reshape(B, N, 3), mv_t,
                                    proj_t)
        st["tuv"] = torch.stack([x.reshape(M) for x in st["fh"][1:4]])

    def march_inputs():
        m = st["march"]
        return (st["rd"].reshape(M, 3), cam_o, st["zw"], st["ff"],
                st["first_tet"], st["tuv"], m["tet_geo"], m["tet_ids"],
                m["shade"], N)

    def k4():
        st["out"] = pt.fwd_march(*march_inputs())

    def assemble():
        out_f, out_i = st["out"]
        act = out_i[3] != 0
        final_T = torch.exp(out_f[4])
        col = [torch.where(act, out_f[c] + final_T * bg[c], bg[c])
               for c in range(3)]
        st["image"] = (
            torch.stack(col).reshape(3, B, h, w).transpose(0, 1).contiguous(),
            torch.where(act, out_f[3] + final_T * 1.0, 1.0).reshape(
                B, 1, h, w), act.reshape(B, h, w))

    seq = [("projection+preprocess", project), ("binning", binning_),
           ("first-hit table", table), ("rays", rays_), ("K3", k3),
           ("march tables+start tet", tables), ("K4", k4),
           ("assembly", assemble)]
    return seq, st, fh_inputs, march_inputs


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


def tet_phases(dev):
    """Phases 12-14: the tet kernels, the tet serving path and its edge
    cases. Returns (the kernels' JSON entries, a dict of tet numbers)."""
    import dmesh_renderer_tpu_torch as port
    from dmesh_renderer_tpu_torch.ops import reduce as rd
    from dmesh_renderer_tpu_torch.ops import tet as pt
    from dmesh_renderer_tpu_torch.ops import tet_first_hit as pfh
    from dmesh_renderer_tpu_torch.ops import tri_binned as tb

    # ---- K3 and K4 against plain: the small scene, then the headline
    n, jit, gs, b, hs, ws, seed = TET_SMALL
    _u, fs, _bg = tet_user(n, b, jit, gs, dev)
    seq_s, _st, fh_s, mi_s = tet_stages(fs, hs, ws, seed)
    for _n, fn in seq_s[:-1]:
        fn()
    err_s, _g3, _v, _g4, eq_s = compare_tet_kernels(
        fh_s(), mi_s(), f"freudenthal_grid(6), {hs}x{ws}, B=2, seed 17")

    H, W = TET_HEADLINE["height"], TET_HEADLINE["width"]
    user, fargs, bg = tet_user(TET_HEADLINE["n_grid"], 1, 0.15, 2, dev)
    seq, st, fh_in, m_in = tet_stages(fargs, H, W)
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
    # outputs (40); the tet and shade tables read once
    k4_bytes = (n_pix * (12 + 16 + 8 + 12 + 40) + m["tet_geo"].numel() * 4
                + m["tet_ids"].numel() * 4 + m["shade"].numel() * 4)
    k4_bound, k4_by, k4_ops_ms, k4_bytes_ms = bound(
        blends * OPS_PER_BLEND + walks * OPS_PER_WALK, k4_bytes)
    log(f"K3 at tet headline: {k3_ms:.4f} ms; plain {k3_plain_ms:.2f} ms. "
        f"Work: {n_pairs} pairs, {walked} slots staged, {need_slots} slots "
        f"needed, {n_visits} (pixel, face) tests -> {k3_ops_ms:.4f} ms; "
        f"{k3_bytes} bytes -> {k3_bytes_ms:.4f} ms; bound {k3_bound:.4f} ms "
        f"by {k3_by}")
    log(f"K4 at tet headline: {k4_ms:.4f} ms; plain {k4_plain_ms:.2f} ms. "
        f"Work: {blends} blends, {walks} walk steps -> {k4_ops_ms:.4f} ms; "
        f"{k4_bytes} bytes -> {k4_bytes_ms:.4f} ms; bound {k4_bound:.4f} ms "
        f"by {k4_by}")

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

    # ---- the tet edge cases on the card
    n, jit, gs, b, hd, wd, _seed = TET_DENSE
    ud, fd, _bgd = tet_user(n, b, jit, gs, dev, seed_offset=1)
    check(fd[1].shape[0] <= pt.BINNED_FIRST_HIT_THRESHOLD, "dense scene size")
    dense = pt.render_tet_forward(*fd, hd, wd, 0)
    saved_thr = pt.BINNED_FIRST_HIT_THRESHOLD
    pt.BINNED_FIRST_HIT_THRESHOLD = 1
    try:
        before = pfh.first_hit.launches
        binned = pt.render_tet_forward(*fd, hd, wd, 0)
        check(pfh.first_hit.launches == before + 1, "forced binned: no K3")
    finally:
        pt.BINNED_FIRST_HIT_THRESHOLD = saved_thr
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
    log(f"tet edge cases: dense (F={fd[1].shape[0]}) vs forced binned at "
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
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by,
         "bit_equal": bool(eq_s[0] and eq_h[0]), "pairs": n_pairs,
         "slots_staged": walked, "slots_needed": need_slots,
         "visits": n_visits, "hit_pixels": hit_pixels},
        {**common, "name": "tet_fwd_march",
         "replaces": "dmesh_renderer_tpu/ops/tet.py:503",
         "launches": launches["tet_fwd_march"],
         "max_abs_err": max(err_s, err_h), "ms": k4_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_by,
         "bit_equal": bool(eq_s[1] and eq_h[1]), "blends": blends,
         "walk_steps": walks, "active": n_act, "max_walk": max_walk},
    ]
    info = {"tet_forward_ms": tet_ms, "tet_forward_split_ms": split,
            "tet_forward_peak_mib": tet_peak / 2**20,
            "tet_card_vs_cpu_pixels": [n_diff, n_near]}
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
    ray_i, ray_f, off, n = pt.bwd_start_state(saved, fargs[10], gc, gd,
                                              fargs[12])
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
    for name, g, p in zip(("keys", "records", "mismatch flags"), got, want):
        check(torch.equal(g, p), f"{label}: K5 {name} differ from plain")
    err = float((got[1] - want[1]).abs().max())
    F, P = fargs[1].shape[0], fargs[0].shape[0]
    gk = pt.reduce_tet_records(*got[:2], fargs[1], P)
    gp = pt.reduce_tet_records(*want[:2], fargs[1], P)
    for g, p in zip(gk, gp):
        err = max(err, float((g - p).abs().max()))
        check(torch.equal(g, p), f"{label}: K5 gradients differ from plain")
    mism = int(got[2].sum())
    log(f"K5 vs plain [{label}]: {inputs[6]} records over "
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
    csr = rd.segment_csr(keys, F + 1)
    face_acc = rd.seg_sum(rec, csr)[:F]
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
    n_rec = k5_in[6]
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
        n_rec * OPS_PER_BWD_VISIT + walks * OPS_PER_BWD_WALK, k5_bytes)
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
    acc1 = rd.seg_sum(rec1, rd.segment_csr(keys1, F + 1))[:F]
    fb_split = {
        "recording forward": cuda_ms(fwd, 2, 10),
        "start state": cuda_ms(lambda: pt.bwd_start_state(
            saved, fargs[10], *ones, fargs[12]), 2, 10),
        "K5": cuda_ms(lambda: pt.bwd_march(*in1), 2, 10),
        "record reduce": cuda_ms(lambda: rd.seg_sum(
            rec1, rd.segment_csr(keys1, F + 1)), 2, 10),
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

    # ---- make_tet_train_step with Adam(1e-2) at the headline
    geom = dmesh.TetGeometry(fargs[0], fargs[1], fargs[9], fargs[10],
                             fargs[11])
    scene = dmesh.TetScene(*[user[i].detach().clone().requires_grad_(True)
                             for i in (2, 3)])
    batch = dmesh.TetViewBatch(*fargs[4:9], torch.zeros((1, 3, H, W),
                                                        device=dev))
    state = dmesh.init_tet_train_state(
        scene, lambda p: torch.optim.Adam(p, lr=1e-2))
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
    step_ms = float(np.mean(step_times[1:]))
    log(f"tet train step (Adam 1e-2, zero target and background): losses "
        + ", ".join(f"{x:.6f}" for x in losses) + f"; {step_ms:.3f} ms/step "
        f"(mean of steps 2-5; step 1 {step_times[0]:.3f} ms)")

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


def profiled_device_ms(fn, kernel, reps=10):
    """The mean device time (ms) of the kernel whose name holds ``kernel``
    over ``reps`` calls of ``fn()`` under the profiler: the kernel's own
    time, without the host's launch cost that events around back-to-back
    calls also see."""
    from torch.profiler import ProfilerActivity, profile

    from dmesh_renderer_tpu_torch.utils import diagnostics as dg

    fn()
    torch.cuda.synchronize()
    # The profiler has been seen to return a window without some or all of
    # its device records (0, 7 or 8 of 10 launches). The mean is taken over
    # the launches a window holds, and said when some are missing; a window
    # that holds none is taken again, at most twice.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = dg.device_time_by_name(prof)
        hits = [(c, ms) for n, (c, ms) in by_name.items() if kernel in n]
        if len(hits) == 1 and 0 < hits[0][0] <= reps:
            if hits[0][0] < reps:
                log(f"profiled {kernel}: the window holds {hits[0][0]} of "
                    f"its {reps} launches; their mean is taken")
            return hits[0][1] / hits[0][0]
        log(f"profiled {kernel}, window {attempt + 1}: {hits} (want up to "
            f"{reps} launches of one kernel); {len(by_name)} device names: "
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
            # the table elements the lookups touch, read once
            touched = int(torch.unique(idx64 * 128 + lane).numel())
            b_ms, b_by, _o, _b = bound(2 * R * 128,
                                       2 * R * 128 * 4 + touched * 4)
            ms, lib_ms = answers["e2"][(S, R)]
            t1[(S, R)] = dict(
                ms=ms,
                device_ms=profiled_device_ms(
                    lambda: ex.take_rows(tab, idx), "take_rows_kernel"),
                plain_ms=measure(lambda: ex.take_rows_plain(tab, idx)),
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                touched=touched)
            r = t1[(S, R)]
            route = "shared memory" if S <= 96 else "L2"
            log(f"T1 take_rows S={S} R={R} ({route}): bit-equal to plain "
                f"and torch.gather; {r['ms']:.4f} ms per call, device "
                f"{r['device_ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f}, torch.gather "
                f"{r['library_ms']:.4f}; {touched} table elements touched; "
                f"bound {b_ms:.5f} ms by {b_by}")
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
    t4_plain = measure(lambda: pm.proto_step_plain(*ptabs))
    log(f"T4 proto_step at {PROBE_RAYS} rays: step 1 and the {pm.REPS}-step "
        f"chain on the random tables, step 1 and the 2-step chain on the "
        f"mesh, bit-equal to plain; step 1 {t4_ms:.4f} ms per call, device "
        f"{t4_dev:.4f} ms (bound {t4_bound:.5f} by {t4_by}), chain "
        f"{t4c_step_ms:.4f} ms/step (bound {t4c_bound / pm.REPS:.5f} "
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
                                    "bound_ms", "bound_by", "library_ms")},
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
         "chain_bound_ms_per_step": t4c_bound / pm.REPS,
         "error_lanes_step1": n_err, "distinct_faces_after_step1": n_cf,
         "distinct_tets_after_step1": n_ct,
         "mesh_lanes_advanced": n_adv},
    ]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
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
    ptxas = {k: ptxas_usage(logs, k) for k in ("seg_sum", "tet_bwd_march")}
    log(f"ptxas: seg_sum {ptxas['seg_sum']}; K5 tet_bwd_march "
        f"{ptxas['tet_bwd_march']}")

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
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    plain_ms = cuda_ms(lambda: tb.fwd_composite_plain(*inputs()), 0, 2)
    plain_peak = torch.cuda.max_memory_allocated() - base_mem
    log(f"K1 at headline: {k1_ms:.4f} ms; plain version {plain_ms:.2f} ms "
        f"(peak extra memory {plain_peak / 2**20:.1f} MiB)")

    # ---- the bound of K1 on this run's data
    visits, hits = needed_work(inputs(), got)
    keys = st["keys"]
    n_pix = H * W * HEADLINE["n_views"]
    nbytes = (keys.starts.numel() * 8 + keys.slot_face.numel() * 4
              + st["ff"].numel() * 4 + st["fi"].numel() * 4
              + n_pix * 12 + n_pix * (6 * 4 + 4))
    bound_ms, bound_by, ops_ms, bytes_ms = bound(
        visits * OPS_PER_VISIT + hits * OPS_PER_HIT, nbytes)
    log(f"K1 work: {visits} visits, {hits} blended-candidate visits -> "
        f"{ops_ms:.4f} ms; {nbytes} bytes -> {bytes_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by}")

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
    k2_err_s, _rec_s, _gin_s = compare_k2(
        inputs_s(), got_s, fargs_s[1], fargs_s[9], fargs_s[0].shape[0],
        st_s["keys"].sigma, "4096 tris, 256x256, B=2", seed=1)
    k2_err_h, rec, gin = compare_k2(
        inputs(), got, fargs[1], fargs[9], fargs[0].shape[0], keys.sigma,
        "headline", seed=0)
    state = got[2:]
    k2_call = lambda: tb.bwd_composite(*inputs()[:6], *state, gin, 1, H, W)
    k2_ms = cuda_ms(k2_call, 2, 10)
    k2_plain_ms = cuda_ms(
        lambda: tb.bwd_composite_plain(*inputs()[:6], *state, gin, 1, H, W),
        0, 1)
    b_visits, b_active, b_live, b_rows = bwd_work(inputs(), state[2])
    # tile ranges, the walked face rows, per pixel the ray (12), K1's state
    # (12) and gin (20), and one record per live (slot, quarter): the
    # kernel writes no other record (the rest of its buffer is zeroed
    # before the launch and is not work the function needs)
    b_bytes = (keys.starts.numel() * 8 + b_rows * FACE_ROW_BYTES
               + n_pix * (12 + 12 + 20) + b_live * tb.REC_COLS * 4)
    k2_bound, k2_by, k2_ops_ms, k2_bytes_ms = bound(
        b_visits * OPS_PER_VISIT + b_active * OPS_PER_BWD_ACTIVE
        + b_live * OPS_PER_LIVE_SLOT, b_bytes)
    log(f"K2 at headline: {k2_ms:.4f} ms; plain version {k2_plain_ms:.2f} "
        f"ms. Work: {b_visits} visits, {b_active} active, {b_live} live "
        f"(slot, quarter) pairs, {b_rows} face rows -> {k2_ops_ms:.4f} ms; "
        f"{b_bytes} bytes -> {k2_bytes_ms:.4f} ms; bound {k2_bound:.4f} ms "
        f"by {k2_by}")

    # ---- seg_sum against plain, bit for bit, at both of the main path's
    # shapes: the headline's record reduce and its vertex reduce
    F = fargs[1].shape[0]
    csr = rd.segment_csr(keys.slot_face, F, inner=4)
    vals = rec.reshape(-1, tb.REC_COLS)
    _gop, g_p, g_vc, g_vd, _gint = tb.records_to_faces(
        rec, keys.slot_face, keys.sigma, inputs()[3], fargs[9])
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
        f"{ss_ms < ss_lib_ms}); plain {ss_plain_ms:.2f} ms")

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
    rec1 = tb.bwd_composite(*inputs()[:6], *state, ones_gin, 1, H, W)
    faces_t = fargs[1]
    fb_split = {
        "forward": cuda_ms(fwd_only, 2, 10),
        "K2": cuda_ms(lambda: tb.bwd_composite(*inputs()[:6], *state,
                                                ones_gin, 1, H, W), 2, 10),
        "record reduce": cuda_ms(lambda: tb.records_to_faces(
            rec1, keys.slot_face, keys.sigma, inputs()[3], fargs[9]), 2, 10),
    }
    gf = tb.records_to_faces(rec1, keys.slot_face, keys.sigma, inputs()[3],
                             fargs[9])
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

    # ---- make_train_step with Adam(1e-2) at the headline
    lv = leaves_of(user)
    scene = dmesh.TriScene(lv[0], lv[1], lv[2])
    batch = dmesh.ViewBatch(fargs[4], fargs[5], fargs[6], fargs[7], fargs[8],
                            fargs[9], torch.zeros(1, 3, H, W, device=dev))
    train_state = dmesh.init_train_state(
        scene, lambda p: torch.optim.Adam(p, lr=1e-2))
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
    step_ms = float(np.mean(step_times[1:]))
    log(f"train step (Adam 1e-2, zero target): losses "
        + ", ".join(f"{x:.6f}" for x in losses))
    log(f"timing: fwd+bwd {fb_ms:.3f} ms/frame; train step {step_ms:.3f} "
        f"ms/step (mean of steps 2-5; step 1 {step_times[0]:.3f} ms)")

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
    answers, probe_launches = tools_main_path(dev)
    probe_entries = probe_kernel_phases(dev, answers, probe_launches)
    tet_head["tri_user"] = user
    diag = diagnostics_phases(dev, fargs, tet_head)

    common = {"route": "cuda"}
    log(json.dumps({"kernels": [
        {**common, "name": "tri_fwd_composite",
         "source": "dmesh_renderer_tpu_torch/csrc/tri_fwd.cu",
         "replaces": "dmesh_renderer_tpu/ops/tri_binned.py:605",
         "launches": launches["tri_fwd_composite"],
         "launches_serving_path": fwd_launches,
         "max_abs_err": max(err_small, err_head),
         "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None,
         "forward_ms": fwd_ms, "forward_split_ms": split,
         "forward_peak_mib": fwd_peak / 2**20,
         "plain_peak_mib": plain_peak / 2**20,
         "num_rendered": int(n_rendered), "visits": visits, "hits": hits},
        {**common, "name": "tri_bwd_composite",
         "source": "dmesh_renderer_tpu_torch/csrc/tri_bwd.cu",
         "replaces": "dmesh_renderer_tpu/ops/tri_binned.py:797",
         "launches": launches["tri_bwd_composite"],
         "max_abs_err": max(k2_err_s, k2_err_h),
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None,
         "visits": b_visits, "active_visits": b_active,
         "live_slot_quarters": b_live, "face_rows": b_rows},
        {**common, "name": "seg_sum",
         "source": "dmesh_renderer_tpu_torch/csrc/tri_bwd.cu",
         "replaces": "dmesh_renderer_tpu/ops/tri_binned.py:301 "
                     "(_reduce_records, an XLA scatter-add: port glue, "
                     "not a TPU kernel)",
         "launches": launches["seg_sum"],
         "launches_tet_train": tet_train_info["tet_seg_sum_launches"],
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
        "diagnostics": diag,
        "experiments": {k: _jsonable(v) for k, v in answers.items()}}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
