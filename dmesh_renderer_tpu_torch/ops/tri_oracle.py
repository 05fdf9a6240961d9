"""Dense tri renderer: O(F) per pixel, no tile binning, with its backward.

A port of the JAX package's ``ops/tri_oracle.py`` in plain torch (it is not
a kernel there either). It is the semantic ground truth of the binned path
and serves scenes without faces, scenes below the binned threshold, and the
tests.

Faces are sorted per view by (depth key, face index), stably, and blended
front to back in chunks: per chunk, coverage, intersection and
interpolation are vectorised over (faces in the chunk x pixels), and the
blend recurrence runs sequentially over the chunk. As in the binned path a
face is tested only against pixels of the tiles in its bounding rect
(``BIN_TILE`` granularity), which decides the coverage of near-plane faces
whose wrapped int32 edge functions pass far outside the rect.

The backward is the reference renderer's hand-written one: a reverse walk
from each pixel's last contributor, T rebuilt by division from the final
prevT, suffix accumulators, the background term (with the alpha == 1
case), and the clamp and Moller-Trumbore gradient chain. Per-face sums are
taken per sorted position and un-permuted; per-vertex sums go through the
deterministic segment sum of ``ops/reduce.py``. Gradients reach verts,
verts_color, faces_opacity, verts_depth and faces_intense only.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..utils.config import BIN_TILE, T_EPS
from .geometry import (
    clamp_bary_uv,
    clamp_bary_uv_grad,
    in_tri,
    preprocess_faces,
    project_verts,
    ray_tri_intersection,
    ray_tri_uv_grads_reference,
    sat_i32,
)
from .rays import generate_rays
from .reduce import faces_to_verts

# Faces per chunk, and the most (face, pixel) pairs one chunk may hold.
CHUNK = 64
_MAX_CHUNK_PAIRS = 1 << 22


def _prepare(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
             verts_depth, faces_intense, height, width):
    """Per-view depth-sorted per-face arrays, each [B, F, ...], and the
    sort ``order`` [B, F] (original face id of each sorted position)."""
    B = mv_t.shape[0]
    ndc, img = project_verts(verts, mv_t, proj_t, width, height)
    pre = preprocess_faces(ndc, img, faces, width, height, BIN_TILE, BIN_TILE)
    sort_key = torch.where(pre["valid"], pre["depth"], float("inf"))
    order = torch.sort(sort_key, dim=1, stable=True).indices  # [B, F]
    bidx = torch.arange(B, device=order.device)[:, None]
    fv = faces.long()[order]  # [B, F, 3]
    rect = torch.cat([pre["rect_min"], pre["rect_max"]], dim=-1)
    return {
        "order": order,
        "p": verts[fv],                                   # [B, F, 3, 3]
        "img": img[bidx[..., None], fv],                  # [B, F, 3, 2]
        "col": verts_color[fv],                           # [B, F, 3, 3]
        "dep": verts_depth[bidx[..., None], fv],          # [B, F, 3]
        "alpha": faces_opacity[order],                    # [B, F]
        "inten": faces_intense[bidx, order],              # [B, F]
        "valid": pre["valid"][bidx, order],               # [B, F]
        "rect": rect[bidx, order],                        # [B, F, 4]
    }


def _chunk_terms(xs, lo, hi, ray_o, ray_d, pixc, tilec):
    """Faces lo..hi of the sorted order against every pixel: hit
    [B, K, N], clamped barycentrics (i0, i1, i2) and region code [B, K, N],
    colour before intensity [B, K, N, 3], colour x intensity and depth."""
    s = slice(lo, hi)
    p, im = xs["p"][:, s, None], xs["img"][:, s, None]  # [B, K, 1, 3, ...]
    cov = in_tri(pixc, im[..., 0, :], im[..., 1, :], im[..., 2, :])
    tuv, nondeg = ray_tri_intersection(
        ray_o[:, None, None], ray_d[:, None],
        p[..., 0, :], p[..., 1, :], p[..., 2, :])
    u_c, v_c, code = clamp_bary_uv(tuv[..., 1], tuv[..., 2])
    i0 = 1.0 - u_c - v_c
    rect = xs["rect"][:, s, None]  # [B, K, 1, 4]
    tx, ty = tilec[..., 0], tilec[..., 1]
    in_rect = ((tx >= rect[..., 0]) & (tx < rect[..., 2])
               & (ty >= rect[..., 1]) & (ty < rect[..., 3]))
    hit = cov & nondeg & xs["valid"][:, s, None] & in_rect

    col3 = xs["col"][:, s, None]  # [B, K, 1, 3, 3]
    icol_raw = (i0[..., None] * col3[..., 0, :]
                + u_c[..., None] * col3[..., 1, :]
                + v_c[..., None] * col3[..., 2, :])
    icol = icol_raw * xs["inten"][:, s, None, None]
    dep3 = xs["dep"][:, s, None]  # [B, K, 1, 3]
    idep = i0 * dep3[..., 0] + u_c * dep3[..., 1] + v_c * dep3[..., 2]
    return hit, (i0, u_c, v_c), code, icol_raw, icol, idep


def _setup(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
           inv_mv_t, inv_proj_t, verts_depth, faces_intense, height, width):
    B = mv_t.shape[0]
    N = height * width
    dev = verts.device
    xs = _prepare(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                  verts_depth, faces_intense, height, width)
    ray_o, ray_d = generate_rays(inv_mv_t, inv_proj_t, width, height)
    ray_o = ray_o[:, 0, 0]  # [B, 3]
    ray_d = ray_d.reshape(B, N, 3)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xsx = torch.arange(width, dtype=torch.float32, device=dev)
    py, px = torch.meshgrid(ys, xsx, indexing="ij")
    pixc = torch.stack([px + 0.5, py + 0.5], dim=-1).reshape(N, 2)
    tilec = sat_i32(pixc / BIN_TILE)
    K = max(1, min(CHUNK, _MAX_CHUNK_PAIRS // max(1, B * N)))
    return xs, ray_o, ray_d, pixc, tilec, K


def _render_impl(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                 inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg,
                 height: int, width: int):
    """Forward. Returns (color [B, 3, H, W], depth [B, 1, H, W]) and the
    backward's state (T, prevT, last_contrib), each [B, H*W]:
    last_contrib is the 1-based sorted position of the last face blended."""
    B = mv_t.shape[0]
    F = faces.shape[0]
    N = height * width
    xs, ray_o, ray_d, pixc, tilec, K = _setup(
        verts, faces, verts_color, faces_opacity, mv_t, proj_t, inv_mv_t,
        inv_proj_t, verts_depth, faces_intense, height, width)
    dev = verts.device

    T = torch.ones(B, N, dtype=torch.float32, device=dev)
    pT = torch.ones(B, N, dtype=torch.float32, device=dev)
    C = torch.zeros(B, N, 3, dtype=torch.float32, device=dev)
    D = torch.zeros(B, N, dtype=torch.float32, device=dev)
    last = torch.zeros(B, N, dtype=torch.int32, device=dev)
    done = torch.zeros(B, N, dtype=torch.bool, device=dev)

    for lo in range(0, F, K):
        if bool(done.all()):
            break
        hi = min(F, lo + K)
        hit, _i, _code, _raw, icol, idep = _chunk_terms(
            xs, lo, hi, ray_o, ray_d, pixc, tilec)
        a = xs["alpha"][:, lo:hi, None]  # [B, K, 1]
        for j in range(hi - lo):
            active = hit[:, j] & ~done
            w = torch.where(active, a[:, j] * T, 0.0)
            C = C + icol[:, j] * w[..., None]
            D = D + idep[:, j] * w
            pT = torch.where(active, T, pT)
            T = torch.where(active, T * (1.0 - a[:, j]), T)
            last = torch.where(active, lo + j + 1, last).to(torch.int32)
            done = done | (active & (T < T_EPS))

    color = C + T[..., None] * bg[None, None, :]
    depth = D + T * 1.0
    color = color.reshape(B, height, width, 3).permute(0, 3, 1, 2)
    depth = depth.reshape(B, 1, height, width)
    return color, depth, (T, pT, last)


def _backward(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
              inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg, state,
              dL_dcolor, dL_ddepth, height: int, width: int):
    """The five gradients (verts [P, 3], verts_color [P, 3], faces_opacity
    [F], verts_depth [B, P], faces_intense [B, F]) of the forward whose
    state is ``state``, for upstream gradients dL_dcolor [B, 3, H, W] and
    dL_ddepth [B, 1, H, W]."""
    final_T, final_pT, last_contrib = state
    B = mv_t.shape[0]
    P = verts.shape[0]
    F = faces.shape[0]
    N = height * width
    dev = verts.device
    xs, ray_o, ray_d, pixc, tilec, K = _setup(
        verts, faces, verts_color, faces_opacity, mv_t, proj_t, inv_mv_t,
        inv_proj_t, verts_depth, faces_intense, height, width)

    gcol = dL_dcolor.permute(0, 2, 3, 1).reshape(B, N, 3)
    gdep = dL_ddepth.reshape(B, N)
    bg_dot = (bg[0] * gcol[..., 0] + bg[1] * gcol[..., 1]
              + bg[2] * gcol[..., 2]) + gdep

    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    T = final_pT
    first = torch.ones(B, N, dtype=torch.bool, device=dev)
    la, lc, ld = zeros(B, N), zeros(B, N, 3), zeros(B, N)
    ar, ard = zeros(B, N, 3), zeros(B, N)
    # per sorted position: opacity, intensity, vertex positions, colours
    # and depths
    go, gi = zeros(B, F), zeros(B, F)
    gp, gc, gd = zeros(B, F, 3, 3), zeros(B, F, 3, 3), zeros(B, F, 3)

    # positions at or past every pixel's last contributor change nothing
    n_walk = int(last_contrib.max()) if last_contrib.numel() else 0
    for lo in reversed(range(0, n_walk, K)):
        hi = min(F, lo + K)
        hit, (i0k, i1k, i2k), code_k, raw_k, icol_k, idep_k = _chunk_terms(
            xs, lo, hi, ray_o, ray_d, pixc, tilec)
        for j in reversed(range(hi - lo)):
            s = lo + j
            active = hit[:, j] & (s < last_contrib)
            a = xs["alpha"][:, s, None]  # [B, 1]
            one_m_a = torch.clamp_min(1.0 - a, 1e-30)
            T = torch.where(active & ~first, T / one_m_a, T)
            first = first & ~active

            icol, idep = icol_k[:, j], idep_k[:, j]
            inten = xs["inten"][:, s, None]  # [B, 1]
            ar_new = la[..., None] * lc + (1.0 - la[..., None]) * ar
            ard_new = la * ld + (1.0 - la) * ard

            dic = gcol * (a * T)[..., None]
            did = gdep * a * T
            dalpha = (((icol - ar_new) * gcol).sum(-1)
                      + (idep - ard_new) * gdep) * T
            bg_coef = torch.where(a == 1.0, -final_pT, -final_T / one_m_a)
            dalpha = dalpha + bg_coef * bg_dot

            dic = torch.where(active[..., None], dic, 0.0)
            did = torch.where(active, did, 0.0)
            dalpha = torch.where(active, dalpha, 0.0)

            ar = torch.where(active[..., None], ar_new, ar)
            ard = torch.where(active, ard_new, ard)
            lc = torch.where(active[..., None], icol, lc)
            ld = torch.where(active, idep, ld)
            la = torch.where(active, a, la)

            col3 = xs["col"][:, s]  # [B, 3 verts, 3 ch]
            dep3 = xs["dep"][:, s]  # [B, 3]
            dL_di = [(dic * col3[:, None, k]).sum(-1) * inten
                     + dep3[:, None, k] * did for k in range(3)]
            dL_duc = -dL_di[0] + dL_di[1]
            dL_dvc = -dL_di[0] + dL_di[2]
            duc_du, duc_dv, dvc_du, dvc_dv = clamp_bary_uv_grad(code_k[:, j])
            dL_du = dL_duc * duc_du + dL_dvc * dvc_du
            dL_dv = dL_duc * duc_dv + dL_dvc * dvc_dv

            p = xs["p"][:, s]  # [B, 3, 3]
            du0, du1, du2, dv0, dv1, dv2 = ray_tri_uv_grads_reference(
                ray_o[:, None], ray_d, p[:, None, 0], p[:, None, 1],
                p[:, None, 2])
            for k, (duk, dvk) in enumerate(((du0, dv0), (du1, dv1),
                                            (du2, dv2))):
                g = dL_du[..., None] * duk + dL_dv[..., None] * dvk
                gp[:, s, k] = torch.where(active[..., None], g, 0.0).sum(1)
            for k, ik in enumerate((i0k[:, j], i1k[:, j], i2k[:, j])):
                gc[:, s, k] = (ik[..., None] * dic).sum(1) * inten
                gd[:, s, k] = (ik * did).sum(1)
            go[:, s] = dalpha.sum(1)
            gi[:, s] = (raw_k[:, j] * dic).sum(-1).sum(1)

    # sorted positions -> original faces (a permutation per view)
    order = xs["order"]

    def unsort(g):
        idx = order.reshape(B, F, *([1] * (g.ndim - 2))).expand(g.shape)
        return torch.zeros_like(g).scatter_(1, idx, g)

    g_fopacity = unsort(go).sum(0)
    g_fintense = unsort(gi)
    g_verts, g_vcolor, g_vdepth = faces_to_verts(
        faces, P, unsort(gp).sum(0), unsort(gc).sum(0), unsort(gd))
    return g_verts, g_vcolor, g_fopacity, g_vdepth, g_fintense


class _RenderTriOracle(torch.autograd.Function):
    """The dense renderer as an autograd Function: gradients for verts,
    verts_color, faces_opacity, verts_depth and faces_intense; None for
    faces, the matrices and bg (the reference's gradient surface)."""

    @staticmethod
    def forward(ctx, verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg,
                height, width):
        color, depth, state = _render_impl(
            verts, faces, verts_color, faces_opacity, mv_t, proj_t,
            inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg, height,
            width)
        ctx.save_for_backward(verts, faces, verts_color, faces_opacity,
                              mv_t, proj_t, inv_mv_t, inv_proj_t,
                              verts_depth, faces_intense, bg, *state)
        ctx.size = (height, width)
        return color, depth

    @staticmethod
    @once_differentiable
    def backward(ctx, dL_dcolor, dL_ddepth):
        saved = ctx.saved_tensors
        g = _backward(*saved[:11], saved[11:], dL_dcolor.contiguous(),
                      dL_ddepth.contiguous(), *ctx.size)
        g_verts, g_vcolor, g_fopacity, g_vdepth, g_fintense = g
        return (g_verts, None, g_vcolor, g_fopacity, None, None, None, None,
                g_vdepth, g_fintense, None, None, None)


def render_tri_oracle(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                      inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg,
                      height: int, width: int):
    """Dense tri renderer. Returns (color [B, 3, H, W], depth [B, 1, H, W]).

    Differentiable in verts, verts_color, faces_opacity, verts_depth and
    faces_intense when any of them requires grad."""
    return _RenderTriOracle.apply(
        verts, faces, verts_color, faces_opacity, mv_t, proj_t, inv_mv_t,
        inv_proj_t, verts_depth, faces_intense, bg, height, width)
