"""Dense tri renderer, forward: O(F) per pixel, no tile binning.

A port of the forward of the JAX package's ``ops/tri_oracle.py`` in plain
torch (it is not a kernel there either). It is the semantic ground truth
of the binned path and serves scenes without faces, scenes below the
binned threshold, and the tests.

Faces are sorted per view by (depth key, face index), stably, and blended
front to back in chunks: per chunk, coverage, intersection and
interpolation are vectorised over (faces in the chunk x pixels), and the
blend recurrence runs sequentially over the chunk. As in the binned path a
face is tested only against pixels of the tiles in its bounding rect
(``BIN_TILE`` granularity), which decides the coverage of near-plane faces
whose wrapped int32 edge functions pass far outside the rect.

Gradients are not ported yet (the JAX oracle's hand-written ``_bwd``).
"""

from __future__ import annotations

import torch

from ..utils.config import BIN_TILE, T_EPS
from .geometry import (
    clamp_bary_uv,
    in_tri,
    preprocess_faces,
    project_verts,
    ray_tri_intersection,
    sat_i32,
)
from .rays import generate_rays

# Faces per chunk, and the most (face, pixel) pairs one chunk may hold.
CHUNK = 64
_MAX_CHUNK_PAIRS = 1 << 22


def _prepare(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
             verts_depth, faces_intense, height, width):
    """Per-view depth-sorted per-face arrays, each [B, F, ...]."""
    B = mv_t.shape[0]
    ndc, img = project_verts(verts, mv_t, proj_t, width, height)
    pre = preprocess_faces(ndc, img, faces, width, height, BIN_TILE, BIN_TILE)
    sort_key = torch.where(pre["valid"], pre["depth"], float("inf"))
    order = torch.sort(sort_key, dim=1, stable=True).indices  # [B, F]
    bidx = torch.arange(B, device=order.device)[:, None]
    fv = faces.long()[order]  # [B, F, 3]
    rect = torch.cat([pre["rect_min"], pre["rect_max"]], dim=-1)
    return {
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
    """hit [B, K, N], interpolated colour [B, K, N, 3] and depth [B, K, N]
    of faces lo..hi of the sorted order."""
    s = slice(lo, hi)
    p, im = xs["p"][:, s, None], xs["img"][:, s, None]  # [B, K, 1, 3, ...]
    cov = in_tri(pixc, im[..., 0, :], im[..., 1, :], im[..., 2, :])
    tuv, nondeg = ray_tri_intersection(
        ray_o[:, None, None], ray_d[:, None],
        p[..., 0, :], p[..., 1, :], p[..., 2, :])
    u_c, v_c, _code = clamp_bary_uv(tuv[..., 1], tuv[..., 2])
    i0 = 1.0 - u_c - v_c
    rect = xs["rect"][:, s, None]  # [B, K, 1, 4]
    tx, ty = tilec[..., 0], tilec[..., 1]
    in_rect = ((tx >= rect[..., 0]) & (tx < rect[..., 2])
               & (ty >= rect[..., 1]) & (ty < rect[..., 3]))
    hit = cov & nondeg & xs["valid"][:, s, None] & in_rect

    col3 = xs["col"][:, s, None]  # [B, K, 1, 3, 3]
    icol = (i0[..., None] * col3[..., 0, :] + u_c[..., None] * col3[..., 1, :]
            + v_c[..., None] * col3[..., 2, :]) * xs["inten"][:, s, None, None]
    dep3 = xs["dep"][:, s, None]  # [B, K, 1, 3]
    idep = i0 * dep3[..., 0] + u_c * dep3[..., 1] + v_c * dep3[..., 2]
    return hit, icol, idep


def render_tri_oracle(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                      inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg,
                      height: int, width: int):
    """Dense tri renderer, forward only. Returns (color [B, 3, H, W],
    depth [B, 1, H, W])."""
    B = mv_t.shape[0]
    F = faces.shape[0]
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

    T = torch.ones(B, N, dtype=torch.float32, device=dev)
    C = torch.zeros(B, N, 3, dtype=torch.float32, device=dev)
    D = torch.zeros(B, N, dtype=torch.float32, device=dev)
    done = torch.zeros(B, N, dtype=torch.bool, device=dev)

    K = max(1, min(CHUNK, _MAX_CHUNK_PAIRS // max(1, B * N)))
    for lo in range(0, F, K):
        if bool(done.all()):
            break
        hi = min(F, lo + K)
        hit, icol, idep = _chunk_terms(xs, lo, hi, ray_o, ray_d, pixc, tilec)
        a = xs["alpha"][:, lo:hi, None]  # [B, K, 1]
        for j in range(hi - lo):
            active = hit[:, j] & ~done
            w = torch.where(active, a[:, j] * T, 0.0)
            C = C + icol[:, j] * w[..., None]
            D = D + idep[:, j] * w
            T = torch.where(active, T * (1.0 - a[:, j]), T)
            done = done | (active & (T < T_EPS))

    color = C + T[..., None] * bg[None, None, :]
    depth = D + T * 1.0
    color = color.reshape(B, height, width, 3).permute(0, 3, 1, 2)
    depth = depth.reshape(B, 1, height, width)
    return color, depth
