"""Randomized parity fuzz of the port's tet renderer against the scalar
NumPy spec.

A port of the JAX package's ``tools/fuzz_tet_parity.py``. It sweeps random
tessellations (Freudenthal grids at varying jitter), opacity profiles (the
alpha == 1 termination and near-zero opacities that force deep walks),
camera radii (cameras inside the tessellation among them) and view counts.
Each config renders through ``render_tet_core`` twice, with the dense first
hit and with the binned one forced (K3 on the card); both runs march with
K4 and back-propagate with K5. Each is held to ``tests/numpy_reference.py``'s
per-pixel transliteration of the CUDA semantics (``render_tet_np`` and
``render_tet_np_backward``, float64): colour, scale-aware depth, the
bit-exact ``active`` mask and both gradients.

``make_config(seed)`` draws the JAX harness's scene for the seed, bit for
bit. The spec costs seconds per config, so ``sweep`` evaluates it in a
process pool over the host's cores. ``--big`` draws the same families on
``freudenthal_grid(4, ...)`` at 48x40, where K3 walks several rounds on
partial tiles; the spec does not scale to that size, so there the card is
held to the port's own render on the CPU: colour and depth within
``CARD_CPU_ATOL``, the mask exact, the gradients within
``CARD_CPU_GRAD_RTOL``.

Usage:
    python -m dmesh_renderer_tpu_torch.tools.fuzz_tet_parity \\
        [n_configs] [start_seed] [--device {cpu,cuda}] [--big]

Prints one line per config and a total; exits non-zero listing every
failure.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from ..api import resolve_device
from ..convert import tet_args_from_numpy
from ..ops import tet as pt
from ..utils.connectivity import build_tet_connectivity, freudenthal_grid
from .fuzz_common import launch_counts, load_test_module, parse_args, report

H, W = 24, 24
BIG_GRID, BIG_H, BIG_W = 4, 48, 40
FWD_ATOL = 3e-5
DEPTH_RTOL = 1e-4
GRAD_RTOL = 2e-4
# --big: the card against the port on the CPU (every stage but the march
# tables' log column and the exp of log T is bit-equal on both devices)
CARD_CPU_ATOL = 1e-5
CARD_CPU_GRAD_RTOL = 1e-5
PATHS = ("dense", "binned")
KERNELS = ("K3", "K4", "K5")


def make_config(seed, big=False):
    """The scene of ``seed``: (the 11 scene arrays of the JAX harness --
    verts, faces, vcolor, fopacity, mv_t, proj_t, fintense, tets,
    face_tets, tet_faces, bg -- views, height, width, label). Without
    ``big``, the JAX harness's config."""
    scenes = load_test_module("scenes")
    rng = np.random.RandomState(seed)
    b = int(rng.choice([1, 2]))
    jitter = float(rng.uniform(0.0, 0.2))
    verts, tets = freudenthal_grid(BIG_GRID if big else 2, jitter=jitter,
                                   seed=seed)
    faces, face_tets, tet_faces = build_tet_connectivity(tets)
    F = faces.shape[0]
    fam = []

    fopacity = rng.uniform(0.2, 0.95, F).astype(np.float32)
    if rng.rand() < 0.4:  # alpha == 1 termination
        fam.append("alpha1")
        fopacity[rng.randint(0, F, size=max(1, F // 8))] = 1.0
    if rng.rand() < 0.35:  # translucent: deep walks
        fam.append("deep")
        fopacity[:] = rng.uniform(0.01, 0.15, F).astype(np.float32)

    if rng.rand() < 0.3:
        fam.append("cam-inside")
        radius = float(rng.uniform(0.2, 0.7))
    else:
        radius = float(rng.uniform(2.0, 4.0))
    mv, proj = scenes.ring_cameras(b, radius=radius)

    vcolor = rng.rand(verts.shape[0], 3).astype(np.float32)
    fintense = rng.uniform(0.5, 1.0, (b, F)).astype(np.float32)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    bg = rng.rand(3).astype(np.float32)
    sc = (verts, faces, vcolor, fopacity, mv_t, proj_t, fintense,
          tets, face_tets, tet_faces, bg)
    h, w = (BIG_H, BIG_W) if big else (H, W)
    label = (f"seed={seed} B={b} F={F} r={radius:.2f} j={jitter:.2f} "
             f"[{','.join(fam) or 'plain'}]")
    return sc, b, h, w, label


def upstream_weights(seed, b, h, w):
    """The loss weights of the colour and depth images (NumPy, so that the
    port and the spec see the same bits)."""
    rng = np.random.RandomState(seed + 7)
    return (rng.randn(b, 3, h, w).astype(np.float32),
            rng.randn(b, 1, h, w).astype(np.float32))


def spec_outputs(seed):
    """The float64 spec of the config of ``seed``: (colour, depth, active,
    dL/dverts_color, dL/dfaces_opacity). NumPy only; the process pool of
    ``sweep`` runs it."""
    spec = load_test_module("numpy_reference")
    sc, b, h, w, _label = make_config(seed)
    wc, wd = upstream_weights(seed, b, h, w)
    c, d, act, aux = spec.render_tet_np(*sc, h, w)
    g = spec.render_tet_np_backward(*sc, h, w, wc, wd, aux)
    return (np.asarray(c), np.asarray(d), np.asarray(act),
            np.asarray(g["verts_color"]), np.asarray(g["faces_opacity"]))


def render(sc, h, w, wc, wd, device, path):
    """``render_tet_core`` of the scene on ``device`` with the ``path``
    first hit, and the gradients of sum(colour * wc) + sum(depth * wd):
    NumPy (colour, depth, active, dL/dverts_color, dL/dfaces_opacity)."""
    (verts, faces, vcolor, fopacity, mv_t, proj_t, fintense, tets,
     face_tets, tet_faces, bg) = sc
    a = tet_args_from_numpy(
        verts, faces, vcolor, fopacity, mv_t, proj_t, np.linalg.inv(mv_t),
        np.linalg.inv(proj_t), fintense, tets, face_tets, tet_faces, bg,
        device=device)
    vc, fo = (x.clone().requires_grad_(True) for x in a[2:4])
    with pt.first_hit_path(path):
        c, d, act = pt.render_tet_core(a[0], a[1], vc, fo, *a[4:], h, w, 0)
    loss = ((c * torch.from_numpy(wc).to(device)).sum()
            + (d * torch.from_numpy(wd).to(device)).sum())
    g_vc, g_fo = torch.autograd.grad(loss, [vc, fo])
    return tuple(x.detach().cpu().numpy() for x in (c, d, act, g_vc, g_fo))


def compare(got, want, fwd_atol, depth_rtol, grad_rtol):
    """The errors of ``got`` against ``want`` (each as ``render``
    returns): the mask exact, colour absolute, depth relative to
    max(1, |want|) (depth is unbounded for rays from inside the mesh), the
    gradients relative to max(1, max |want|)."""
    c, d, act, g_vc, g_fo = got
    c_n, d_n, act_n, g_vc_n, g_fo_n = want
    errs = []
    if not np.array_equal(act, act_n):
        errs.append(f"active mask differs ({int(np.sum(act != act_n))} px)")
    e_c = float(np.abs(c - c_n).max())
    e_d = float((np.abs(d - d_n) / np.maximum(1.0, np.abs(d_n))).max())
    if e_c > fwd_atol or e_d > depth_rtol:
        errs.append(f"fwd color={e_c:.2e} depth_rel={e_d:.2e}")
    for g, g_n, name in ((g_vc, g_vc_n, "vcolor"), (g_fo, g_fo_n, "fopacity")):
        g, g_n = np.asarray(g, np.float64), np.asarray(g_n, np.float64)
        err = np.abs(g - g_n).max() / max(1.0, np.abs(g_n).max())
        if err > grad_rtol:
            errs.append(f"grad {name} rel={err:.2e}")
    return errs


def check_config(seed, device, spec=None, big=False):
    """Render the config of ``seed`` on ``device`` with both first-hit
    paths and hold each to the spec (``spec``: ``spec_outputs(seed)``,
    computed here when None) or, with ``big``, to the port on the CPU.
    Returns (label, errors), each error prefixed by its path."""
    sc, b, h, w, label = make_config(seed, big)
    dev = torch.device(device)
    wc, wd = upstream_weights(seed, b, h, w)
    errs = []
    for path in PATHS:
        got = render(sc, h, w, wc, wd, dev, path)
        if big:
            want = render(sc, h, w, wc, wd, torch.device("cpu"), path)
            e = compare(got, want, CARD_CPU_ATOL, CARD_CPU_ATOL,
                        CARD_CPU_GRAD_RTOL)
        else:
            if spec is None:
                spec = spec_outputs(seed)
            e = compare(got, spec, FWD_ATOL, DEPTH_RTOL, GRAD_RTOL)
        errs += [f"{path}: {x}" for x in e]
    return label, errs


def _spec_pool_size(n):
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else os.cpu_count()
    return max(1, min(n, cores or 1))


def sweep(seeds, device, big=False):
    """Check every seed, printing a line each. The specs are evaluated
    first, in a pool of spawned processes over the host's cores (each
    imports the caller's main module, so a script that calls this keeps
    its work under ``if __name__ == "__main__"``). Returns ([(label,
    errors)], the launches of K3, K4 and K5 during the sweep)."""
    seeds = list(seeds)
    specs = [None] * len(seeds)
    if not big and len(seeds) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(_spec_pool_size(len(seeds)),
                                 mp_context=ctx) as pool:
            specs = list(pool.map(spec_outputs, seeds))
    before = launch_counts()
    results = []
    for seed, spec in zip(seeds, specs):
        label, errs = check_config(seed, device, spec, big)
        print(f"{label}: {'FAIL ' + '; '.join(errs) if errs else 'ok'}",
              flush=True)
        results.append((label, errs))
    after = launch_counts()
    return results, {k: after[k] - before[k] for k in KERNELS}


def main(argv=None):
    args = parse_args(argv, "fuzz_tet_parity", 30, 2000)
    dev = resolve_device(args.device)
    results, launched = sweep(
        range(args.start_seed, args.start_seed + args.n_configs), dev,
        args.big)
    return report(results, launched, dev, KERNELS)


if __name__ == "__main__":
    sys.exit(main())
