"""Drive the torch port's tri renderer, forward and backward, on one CUDA
card and check it.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one) and nvcc. Steps:

1. print the card (name, count, nvidia-smi name and power limit);
2. build the CUDA kernels of dmesh_renderer_tpu_torch/csrc (one nvcc per
   source, all at once) and print the build time and ptxas usage;
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
   reduce), and time it beside ``torch.segment_reduce``;
8. drive the training path, ``TriRenderer`` on leaf tensors that require
   grad at the headline with the loss sum(color) + sum(depth), then
   ``backward()``, counts set to 0 just before and read just after; check
   the gradients, run it twice (bitwise equal), time it and split it;
9. binned against the oracle on the card, all five gradients at 4096
   triangles; zero gradients of empty geometry;
10. ``models.dmesh.make_train_step`` with Adam(1e-2) at the headline (zero
    target and background), 5 steps: the loss falls;
11. the B=2 scene (20k triangles, 800x800) with gradients;
12. print one JSON line of per-kernel numbers, and as the last line
    ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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
    ss_ms = cuda_ms(lambda: rd.seg_sum(vals, csr), 2, 10)
    ss_plain_ms = cuda_ms(lambda: rd.seg_sum_plain(vals, csr), 0, 1)
    data = vals.index_select(0, csr.order)
    lib = torch.segment_reduce(data, "sum", offsets=csr.offsets)
    check(rel(lib, rd.seg_sum(vals, csr)) <= 1e-5,
          "segment_reduce disagrees with seg_sum")
    ss_lib_ms = cuda_ms(
        lambda: torch.segment_reduce(data, "sum", offsets=csr.offsets), 2, 10)
    N, C = vals.shape
    ss_bound, ss_by, _o, _b = bound(
        N * C, N * C * 4 + N * 8 + csr.offsets.numel() * 8 + F * C * 4)
    log(f"seg_sum at the headline record reduce ({N} x {C} -> {F} x {C}): "
        f"{ss_ms:.4f} ms, plain {ss_plain_ms:.2f} ms, "
        f"torch.segment_reduce on the CSR-ordered rows {ss_lib_ms:.4f} ms; "
        f"bound {ss_bound:.4f} ms by {ss_by}")

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
         "launches": launches["seg_sum"], "max_abs_err": ss_err,
         "ms": ss_ms, "plain_ms": ss_plain_ms, "bound_ms": ss_bound,
         "bound_by": ss_by, "library_ms": ss_lib_ms,
         "shape": [N, C, F]},
    ], "fwd_bwd_ms": fb_ms, "fwd_bwd_split_ms": fb_split,
        "fwd_bwd_peak_mib": fb_peak / 2**20,
        "forward_no_grad_after_ms": fwd_nograd_ms, "train_step_ms": step_ms,
        "train_losses": losses}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
