"""Randomized binned-vs-oracle parity fuzz of the port's tri renderer.

A port of the JAX package's ``tools/fuzz_tri_parity.py``. It sweeps random
scene families -- plain soups, zero-area faces, offscreen faces, near-plane
(int32-wrap) vertices, mixed opacities with alpha == 1, huge faces, odd
image sizes, several views -- and compares the binned path
(``render_tri_binned``: K1, K2 and ``seg_sum`` on the card) with the dense
oracle (``render_tri_oracle``), both on the chosen device: the forward
images and all five gradients through ``torch.autograd``. The near-plane
coverage bug of the JAX package was found by this kind of sweep; run it
after touching emission, the face tables, or either kernel.

``make_config(seed)`` draws the JAX harness's scene for the seed, bit for
bit (the same NumPy draws, families and buckets, from the repository's
``tests/scenes.py``). ``--big`` draws the same configs at the card-only
sizes, soups of 256 and 1,024 triangles at 64x64 and 96x80 (by the seed,
so four seeds in a row cover all four), whose tile lists run past K1's
and K2's 32-slot rounds.

A binned-vs-oracle miss beyond the tolerance is arbitrated against the
float64 scalar spec (``tests/numpy_reference.py``): extreme geometry gives
both f32 paths rounding of a few 1e-4, so a config fails only where the
binned path is materially farther from the spec than the oracle is.

Usage:
    python -m dmesh_renderer_tpu_torch.tools.fuzz_tri_parity \\
        [n_configs] [start_seed] [--device {cpu,cuda}] [--big]

Prints one line per config and a total; exits non-zero listing every
failure.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..api import resolve_device
from ..ops.tri_binned import render_tri_binned
from ..ops.tri_oracle import render_tri_oracle
from ..utils.config import BIN_TILE
from .fuzz_common import launch_counts, load_test_module, parse_args, report

FWD_ATOL = 3e-5
GRAD_RTOL = 2e-4
# A binned-vs-oracle disagreement beyond the tolerance fails only if the
# binned path is farther from the f64 spec than this times the oracle's
# distance (the JAX harness's seed 1022: the oracle 2.9e-4 from the spec,
# the binned path 1.1e-4).
SPEC_SLACK = 1.25
SIZES = (16, 24)
SHAPES = ((48, 40), (47, 33), (64, 64))
BIG_SIZES = (256, 1024)
BIG_SHAPES = ((64, 64), (96, 80))
KERNELS = ("K1", "K2", "seg_sum")
GRAD_NAMES = ("verts", "vcolor", "fopacity", "vdepth", "fintense")
SPEC_KEYS = {"verts": "verts", "vcolor": "verts_color",
             "fopacity": "faces_opacity", "vdepth": "verts_depth",
             "fintense": "faces_intense"}


def make_config(seed, big=False):
    """The scene of ``seed``: (the 11 functional arguments of the tri
    renderer as NumPy arrays -- verts, faces, verts_color, faces_opacity,
    mv_t, proj_t, inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg --
    height, width, label). Without ``big``, the JAX harness's config."""
    scenes = load_test_module("scenes")
    rng = np.random.RandomState(seed)
    # shapes come from small buckets (the JAX harness's reason: its jit
    # caches); the scene content varies freely
    n_tris = int(rng.choice(SIZES))
    b = int(rng.choice([1, 2]))
    h, w = SHAPES[int(rng.randint(3))]
    if big:  # the same draws, at the size and shape the seed picks
        n_tris = BIG_SIZES[seed % 2]
        h, w = BIG_SHAPES[seed // 2 % 2]
    soup = scenes.random_triangle_soup(n_tris, seed=seed)
    mv, proj = scenes.ring_cameras(b, radius=float(rng.uniform(2.0, 4.0)))
    v = soup["verts"].copy()
    fo = soup["faces_opacity"].copy()
    fam = []

    if rng.rand() < 0.4:  # zero-area faces
        fam.append("zero-area")
        for i in range(min(4, n_tris)):
            f = soup["faces"][i]
            v[f[1]] = v[f[0]]
    if rng.rand() < 0.4:  # offscreen faces
        fam.append("offscreen")
        for i in range(min(3, n_tris)):
            v[soup["faces"][-1 - i][0]] += np.array([50.0, 50.0, 0.0])
    if rng.rand() < 0.35:  # near-plane / int32-wrap vertices
        fam.append("near-plane")
        inv = np.linalg.inv(mv[0])
        for i in range(min(4, n_tris)):
            zv = float(rng.uniform(-3e-4, 1e-3))
            pv = np.array([float(rng.uniform(-2, 2)),
                           float(rng.uniform(-2, 2)), zv, 1.0])
            v[soup["faces"][i][1]] = (inv @ pv)[:3]
    if rng.rand() < 0.4:  # saturating opacities (alpha == 1)
        fam.append("alpha1")
        fo[rng.randint(0, n_tris, size=max(1, n_tris // 4))] = 1.0
    if rng.rand() < 0.3:  # huge triangles spanning many tiles
        fam.append("huge")
        for i in range(min(2, n_tris)):
            f = soup["faces"][i]
            c = v[f].mean(axis=0)
            v[f] = c + (v[f] - c) * 8.0

    vdepth, fintense = scenes.soup_view_attrs(soup, b, seed=seed + 1)
    bg = rng.rand(3).astype(np.float32)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    args = (v, soup["faces"], soup["verts_color"], fo, mv_t, proj_t,
            np.linalg.inv(mv_t), np.linalg.inv(proj_t), vdepth, fintense, bg)
    label = (f"seed={seed} B={b} F={n_tris} {h}x{w} "
             f"[{','.join(fam) or 'plain'}]")
    return args, h, w, label


def upstream_weights(b, h, w):
    """The loss weights of the colour and depth images: cos and sin of an
    f32 arange, in NumPy, so that both paths and the spec see the same
    bits."""
    tc = np.cos(np.arange(b * 3 * h * w, dtype=np.float32)).reshape(b, 3, h, w)
    td = np.sin(np.arange(b * h * w, dtype=np.float32)).reshape(b, 1, h, w)
    return tc, td


def _grads(render, t, h, w, tc, td):
    leaves = [t[i].clone().requires_grad_(True) for i in (0, 2, 3, 8, 9)]
    c, d = render(leaves[0], t[1], leaves[1], leaves[2], *t[4:8], leaves[3],
                  leaves[4], t[10], h, w)
    loss = (c * tc).sum() + (d * td).sum()
    return torch.autograd.grad(loss, leaves)


def check_config(seed, device, big=False):
    """Render the config of ``seed`` both ways on ``device`` and compare.
    Returns (label, errors)."""
    args, h, w, label = make_config(seed, big)
    dev = torch.device(device)
    t = [torch.from_numpy(a).to(dev) for a in args]
    errs = []

    co, do_ = render_tri_oracle(*t, h, w)
    cb, db = render_tri_binned(*t, h, w)
    e_c = float((cb - co).abs().max())
    e_d = float((db - do_).abs().max())
    if e_c > FWD_ATOL or e_d > FWD_ATOL:
        # both f32 paths round extreme near-plane geometry by a few 1e-5:
        # fail only if the binned image is materially farther from the f64
        # spec than the oracle's
        cs, ds = spec_forward(args, h, w)
        e_bo = max(np.abs(cb.cpu().numpy() - cs).max(),
                   np.abs(db.cpu().numpy() - ds).max())
        e_oo = max(np.abs(co.cpu().numpy() - cs).max(),
                   np.abs(do_.cpu().numpy() - ds).max())
        if e_bo > SPEC_SLACK * max(e_oo, FWD_ATOL / 2):
            errs.append(f"fwd color={e_c:.2e} depth={e_d:.2e} "
                        f"(spec: binned={e_bo:.2e} oracle={e_oo:.2e})")
        else:
            print(f"  [spec-arbitrated] fwd: binned-vs-oracle "
                  f"color={e_c:.2e} depth={e_d:.2e}; vs f64 spec "
                  f"binned={e_bo:.2e} oracle={e_oo:.2e}", flush=True)

    b = args[4].shape[0]
    tc, td = upstream_weights(b, h, w)
    tct, tdt = torch.from_numpy(tc).to(dev), torch.from_numpy(td).to(dev)
    g_o = _grads(render_tri_oracle, t, h, w, tct, tdt)
    g_b = _grads(render_tri_binned, t, h, w, tct, tdt)
    g_spec = None
    for a, bb, name in zip(g_o, g_b, GRAD_NAMES):
        a = a.detach().cpu().double().numpy()
        bb = bb.detach().cpu().double().numpy()
        scale = max(1.0, np.abs(a).max())
        err = np.abs(a - bb).max() / scale
        if err > GRAD_RTOL:
            if g_spec is None:
                g_spec = spec_grads(args, h, w)
            truth = np.asarray(g_spec[SPEC_KEYS[name]], np.float64)
            e_o = np.abs(a - truth).max() / scale
            e_b = np.abs(bb - truth).max() / scale
            if e_b > SPEC_SLACK * max(e_o, GRAD_RTOL / 2):
                errs.append(f"grad {name} rel={err:.2e} "
                            f"(spec: binned={e_b:.2e} oracle={e_o:.2e})")
            else:
                print(f"  [spec-arbitrated] grad {name}: "
                      f"binned-vs-oracle {err:.2e}; vs f64 spec "
                      f"binned={e_b:.2e} oracle={e_o:.2e}", flush=True)
    return label, errs


def spec_forward(args, h, w):
    """The f64 forward images of the scalar spec, on the BIN_TILE rect
    grid (see ``spec_grads``)."""
    spec = load_test_module("numpy_reference")
    v, faces, vcolor, fo, mv_t, proj_t = args[:6]
    vdepth, fint, bg = args[8:11]
    f64 = lambda a: a.astype(np.float64)
    c, d, _aux = spec.render_tri_np(
        f64(v), faces, f64(vcolor), f64(fo), f64(mv_t), f64(proj_t),
        f64(vdepth), f64(fint), f64(bg), h, w, tile=BIN_TILE)
    return np.asarray(c), np.asarray(d)


def spec_grads(args, h, w):
    """The f64 gradients of the scalar spec. ``tile=BIN_TILE``: the rect
    restriction is the one tile-size-dependent semantic (wrapped near-plane
    coverage), and both of the port's paths quantise rects at BIN_TILE, so
    the spec arbitrates on the same grid."""
    spec = load_test_module("numpy_reference")
    v, faces, vcolor, fo, mv_t, proj_t = args[:6]
    vdepth, fint, bg = args[8:11]
    tc, td = upstream_weights(mv_t.shape[0], h, w)
    _, _, aux = spec.render_tri_np(v, faces, vcolor, fo, mv_t, proj_t,
                                   vdepth, fint, bg, h, w, tile=BIN_TILE)
    return spec.render_tri_np_backward(v, faces, vcolor, fo, mv_t, proj_t,
                                       vdepth, fint, bg, h, w, tc, td, aux)


def sweep(seeds, device, big=False):
    """Check every seed, printing a line each. Returns ([(label, errors)],
    the launches of K1, K2 and ``seg_sum`` during the sweep)."""
    before = launch_counts()
    results = []
    for seed in seeds:
        label, errs = check_config(seed, device, big)
        print(f"{label}: {'FAIL ' + '; '.join(errs) if errs else 'ok'}",
              flush=True)
        results.append((label, errs))
    after = launch_counts()
    return results, {k: after[k] - before[k] for k in KERNELS}


def main(argv=None):
    args = parse_args(argv, "fuzz_tri_parity", 40, 1000)
    dev = resolve_device(args.device)
    results, launched = sweep(
        range(args.start_seed, args.start_seed + args.n_configs), dev,
        args.big)
    return report(results, launched, dev, KERNELS)


if __name__ == "__main__":
    sys.exit(main())
