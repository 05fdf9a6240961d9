"""Drive the torch port's tri forward on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one) and nvcc. Steps:

1. print the card (name, count, nvidia-smi name and power limit);
2. build the CUDA kernels of dmesh_renderer_tpu_torch/csrc (one nvcc per
   source, all at once) and print the build time;
3. hold the compositing kernel (K1, ``fwd_composite``) against its plain
   torch version on the card, at 4096 triangles, 256x256, B=2 and at the
   headline scene (100k triangles, 800x800, B=1, seed 0);
4. drive the main path, ``TriRenderer`` on the card at the headline scene,
   with the launch counts set to 0 just before and read just after; check
   its outputs, time it (2 warm-up, 10 timed runs, CUDA events) and split
   the time by stage;
5. check the edge cases on the card: no faces, no vertices, B=2 at 800x800
   with 20k triangles, and binned against the dense oracle at 4096
   triangles;
6. print one JSON line of per-kernel numbers, and as the last line
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
# (face, tile) pairs the headline scene emits: a property of the scene and
# the exact-emission rule, the same count the JAX package's binning reports
# for it (BENCH_r04.json, roofline tri_emit_sort.events)
HEADLINE_PAIRS = 770_003
TOL = 1e-5  # kernel against plain: the same f32 ops in the same order
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


def needed_work(inputs, got):
    """(visits, hits) this run's data needs: per pixel, the slots of its
    tile up to the one that finished it (all of them if none did), and how
    many of those cover the pixel."""
    from dmesh_renderer_tpu_torch.ops.geometry import edge_value
    from dmesh_renderer_tpu_torch.utils.config import T_EPS

    starts, ends, slot_face, ff, fi, _rd, B, H, W = inputs
    _C, _D, T, _pT, nc = got
    gx, gy = (W + 31) // 32, (H + 31) // 32
    dev = T.device
    # per-tile 32x32 pixel blocks (pixels past the image get stop 0)
    Tp = torch.ones(B, gy * 32, gx * 32, device=dev)
    ncp = torch.zeros(B, gy * 32, gx * 32, dtype=torch.int64, device=dev)
    Tp[:, :H, :W] = T
    ncp[:, :H, :W] = nc.long()
    inside = torch.zeros_like(ncp, dtype=torch.bool)
    inside[:, :H, :W] = True
    tile_of = lambda x: x.reshape(B, gy, 32, gx, 32).permute(
        0, 1, 3, 2, 4).reshape(B * gy * gx, 1024)
    count = (ends - starts).long()
    stop = torch.where(tile_of(Tp) < T_EPS, tile_of(ncp), count[:, None])
    stop = torch.where(tile_of(inside), stop, 0)  # [NT, 1024]
    visits = int(stop.sum())
    yy, xx = torch.meshgrid(torch.arange(32, device=dev),
                            torch.arange(32, device=dev), indexing="ij")
    S = slot_face.numel()
    tile_of_slot = torch.repeat_interleave(
        torch.arange(count.numel(), device=dev), count, output_size=S)
    pos = torch.arange(S, device=dev) - starts.long()[tile_of_slot]
    hits = 0
    for s0 in range(0, S, 4096):
        sl = slice(s0, min(S, s0 + 4096))
        t = tile_of_slot[sl]
        ty, tx = (t % (gy * gx)) // gx, t % gx
        px = ((tx[:, None] * 32 + xx.reshape(1, -1)) * 16 + 8)
        py = ((ty[:, None] * 32 + yy.reshape(1, -1)) * 16 + 8)
        row = slot_face[sl].long()
        e = fi[row].long()
        cov = (pos[sl, None] < stop[t]) & (ff[row, 26, None] > 0)
        for i in range(3):
            cov &= edge_value(e[:, i, None], e[:, 3 + i, None],
                              e[:, 6 + i, None], px, py) < 0
        hits += int(cov.sum())
    return visits, hits


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import dmesh_renderer_tpu_torch as port
    from dmesh_renderer_tpu_torch import kernels
    from dmesh_renderer_tpu_torch.ops import tri_binned as tb

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
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    # ---- K1 against plain: 4096 tris at 256^2, B=2; then the headline
    small = dict(n_tris=4096, n_views=2, height=256, width=256, seed=1)
    _u, fargs_s, _bg = scene_tensors(**small, dev=dev)
    seq, _st, inputs_s = stages(fargs_s, small["height"], small["width"])
    for _n, fn in seq[:-1]:
        fn()
    err_small, _ = compare_kernel(inputs_s(), "4096 tris, 256x256, B=2")

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
    ops = visits * OPS_PER_VISIT + hits * OPS_PER_HIT
    keys = st["keys"]
    n_pix = H * W * HEADLINE["n_views"]
    nbytes = (keys.starts.numel() * 8 + keys.slot_face.numel() * 4
              + st["ff"].numel() * 4 + st["fi"].numel() * 4
              + n_pix * 12 + n_pix * (6 * 4 + 4))
    ops_ms, bytes_ms = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    log(f"K1 work: {visits} visits, {hits} blended-candidate visits, "
        f"{ops:.4g} ops -> {ops_ms:.4f} ms; {nbytes} bytes -> "
        f"{bytes_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by}")

    # ---- the main path: TriRenderer on the card at the headline scene
    settings = port.TriRenderSettings(H, W, bg)
    renderer = port.TriRenderer(settings, device="cuda")
    tb.fwd_composite.launches = 0
    color, depth, (ovf, n_rendered) = renderer(*user, return_aux=True)
    torch.cuda.synchronize()
    launches = {"tri_fwd_composite": tb.fwd_composite.launches}
    check(launches["tri_fwd_composite"] >= 1, "main path did not run K1")
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
    log(f"main path: num_rendered {int(n_rendered)}, overflow {bool(ovf)}, "
        f"covered pixels {covered:.4f}, K1 launches {launches}")
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

    # ---- edge cases on the card
    r_small = port.TriRenderer(port.TriRenderSettings(64, 48, bg), "cuda")
    u = user
    c, d = r_small(u[0], u[1][:0], u[2], u[3][:0], u[4], u[5], u[6],
                   u[7][:, :0])
    check(bool((c == bg[None, :, None, None]).all() and (d == 1).all()),
          "F==0 must give bg and depth 1")
    c, d = r_small(u[0][:0], u[1][:0], u[2][:0], u[3][:0], u[4], u[5],
                   u[6][:, :0], u[7][:, :0])
    check(not bool(c.any() or d.any()), "P==0 must give zeros")
    two = dict(n_tris=20_000, n_views=2, height=800, width=800, seed=2)
    u2, _f2, _bg2 = scene_tensors(**two, dev=dev)
    before = tb.fwd_composite.launches
    c, d = port.TriRenderer(port.TriRenderSettings(800, 800, bg), "cuda")(*u2)
    torch.cuda.synchronize()
    check(tb.fwd_composite.launches == before + 1, "B=2 did not run K1")
    check(c.shape == (2, 3, 800, 800) and bool(torch.isfinite(c).all()
                                               and torch.isfinite(d).all()),
          "B=2 outputs")
    from dmesh_renderer_tpu_torch.ops.tri import render_tri_auto

    cb, db = render_tri_auto(*fargs_s, 256, 256, force="binned")
    co, do = render_tri_auto(*fargs_s, 256, 256, force="oracle")
    e_or = max(float((cb - co).abs().max()), float((db - do).abs().max()))
    check(e_or <= 2e-5, f"binned vs oracle on the card: {e_or}")
    log(f"edge cases: F==0, P==0, B=2 800x800 20k tris ok; binned vs dense "
        f"oracle at 4096 tris: max_abs_err {e_or:.3g} (tol 2e-5)")

    log(json.dumps({"kernels": [{
        "name": "tri_fwd_composite",
        "route": "cuda",
        "source": "dmesh_renderer_tpu_torch/csrc/tri_fwd.cu",
        "replaces": "dmesh_renderer_tpu/ops/tri_binned.py:605",
        "launches": launches["tri_fwd_composite"],
        "max_abs_err": max(err_small, err_head),
        "max_abs_err_vs_plain": max(err_small, err_head),
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "forward_ms": fwd_ms,
        "forward_split_ms": split,
        "forward_peak_mib": fwd_peak / 2**20,
        "plain_peak_mib": plain_peak / 2**20,
        "num_rendered": int(n_rendered),
        "visits": visits,
        "hits": hits,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
