"""Tile-binned tri renderer, forward: the scaled path of the tri renderer.

A port of the forward half of the JAX package's ``ops/tri_binned.py``:

  project_verts + preprocess_faces -> emit_and_sort (binning.py)
  -> depth-sorted per-face table (``build_face_table``)
  -> generate_rays -> ``fwd_composite`` (the CUDA kernel csrc/tri_fwd.cu)

``fwd_composite`` composites every 32x32 tile's depth-sorted face list
front to back per pixel: fixed-point coverage from the int32 edge
coefficients, permissive Moller-Trumbore from the per-face constants
T = o - p0, E1, E2, Q = T x E1, clamped barycentrics, colour x intensity
and vertex depth interpolation, and the blend with the T < 1e-4 early exit.
The kernel looks up each slot's face row itself (``slot_face``), so no
slot-scale attribute table is built.

The face table is compact: [B*F, 27] f32 (TV, E1, E2, Q, 9 corner colours,
3 vertex depths, opacity, intensity, nondeg) and [B*F, 9] int32 edge
coefficients (A1 A2 A3 B1 B2 B3 C1 C2 C3), rows in the per-view
depth-sorted order of ``BinnedKeys.slot_face``.

Gradients are not ported yet: the backward lands with the port of the JAX
package's ``tri_binned._bwd_kernel``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.config import BIN_TILE, T_EPS
from .binning import default_key_capacity, emit_and_sort
from .geometry import (
    clamp_bary_uv,
    cross,
    edge_value,
    face_edge_coeffs,
    preprocess_faces,
    project_verts,
)
from .rays import generate_rays

TILE = BIN_TILE
FACE_F32_COLS = 27
FACE_I32_COLS = 9
# f32 face-table columns
_TV, _E1, _E2, _QV, _C0, _D0 = 0, 3, 6, 9, 12, 21
_ALPHA, _INTEN, _NONDEG = 24, 25, 26


def build_face_table(verts, faces, verts_color, faces_opacity, verts_depth,
                     faces_intense, img, cam_o):
    """Per-(view, face) tables in original view * F + face order.

    Returns (face_f32 [B*F, 27], face_i32 [B*F, 9])."""
    B = cam_o.shape[0]
    F = faces.shape[0]
    fl = faces.long()
    gv = verts[fl]  # [F, 3, 3]
    p0, p1, p2 = gv[:, 0], gv[:, 1], gv[:, 2]
    e1 = p1 - p0
    e2 = p2 - p0
    tv = cam_o[:, None, :] - p0[None]  # [B, F, 3]
    qv = cross(tv, e1[None].expand(tv.shape))
    c = verts_color[fl].reshape(F, 9)  # corner-major rgb
    d = verts_depth[:, fl]  # [B, F, 3]
    eA, eB, eC, nondeg = face_edge_coeffs(img, faces)
    face_f32 = torch.cat([
        tv,
        e1[None].expand(B, F, 3),
        e2[None].expand(B, F, 3),
        qv,
        c[None].expand(B, F, 9),
        d,
        faces_opacity[None, :, None].expand(B, F, 1),
        faces_intense[..., None],
        nondeg.float()[..., None],
    ], dim=-1).reshape(B * F, FACE_F32_COLS)
    face_i32 = torch.stack(list(eA) + list(eB) + list(eC), dim=-1)
    return face_f32.contiguous(), face_i32.reshape(B * F, FACE_I32_COLS)


def _check_composite_args(starts, ends, slot_face, face_f32, face_i32, ray_d,
                          B, H, W):
    n_tiles = B * ((H + TILE - 1) // TILE) * ((W + TILE - 1) // TILE)
    want = (
        (starts, torch.int32, (n_tiles,)),
        (ends, torch.int32, (n_tiles,)),
        (slot_face, torch.int32, None),
        (face_f32, torch.float32, (face_f32.shape[0], FACE_F32_COLS)),
        (face_i32, torch.int32, (face_f32.shape[0], FACE_I32_COLS)),
        (ray_d, torch.float32, (B, H, W, 3)),
    )
    if slot_face.ndim != 1:
        raise ValueError("fwd_composite: slot_face must be 1-D")
    for t, dtype, shape in want:
        if t.dtype != dtype:
            raise TypeError(f"fwd_composite: expected {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(
                f"fwd_composite: expected shape {shape}, got "
                f"{tuple(t.shape)}")
        if t.device != ray_d.device:
            raise ValueError("fwd_composite: all tensors must share a device")


def fwd_composite(starts, ends, slot_face, face_f32, face_i32, ray_d,
                  B: int, H: int, W: int):
    """Composite every tile's face list front to back (kernel K1).

    starts/ends [B*gy*gx] int32 tile ranges into ``slot_face`` [S] int32
    (rows of the depth-sorted face tables); ray_d [B, H, W, 3] f32.
    Returns (C [B, 3, H, W], D, T, prevT [B, H, W] f32, n_contrib [B, H, W]
    int32), n_contrib being the 1-based list position of the last face
    blended into the pixel.

    On CUDA tensors this launches the kernel of csrc/tri_fwd.cu (and raises
    if it cannot); on CPU tensors it runs ``fwd_composite_plain``."""
    _check_composite_args(starts, ends, slot_face, face_f32, face_i32, ray_d,
                          B, H, W)
    if ray_d.device.type == "cpu":
        return fwd_composite_plain(starts, ends, slot_face, face_f32,
                                   face_i32, ray_d, B, H, W)
    if ray_d.device.type != "cuda":
        raise ValueError(f"fwd_composite: unsupported device {ray_d.device}")
    from ..kernels import load

    lib = load("tri_fwd")
    tensors = [x.contiguous() for x in (starts, ends, slot_face, face_f32,
                                        face_i32, ray_d)]
    out = torch.empty((B, 6, H, W), dtype=torch.float32, device=ray_d.device)
    nc = torch.empty((B, H, W), dtype=torch.int32, device=ray_d.device)
    with torch.cuda.device(ray_d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tri_fwd_composite(
            *[ctypes.c_void_p(t.data_ptr()) for t in tensors + [out, nc]],
            B, H, W, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"tri_fwd_composite launch failed: CUDA error {err}")
    fwd_composite.launches += 1
    return out[:, 0:3], out[:, 3], out[:, 4], out[:, 5], nc


fwd_composite.launches = 0


def fwd_composite_plain(starts, ends, slot_face, face_f32, face_i32, ray_d,
                        B: int, H: int, W: int):
    """Plain torch version of ``fwd_composite``: the same inputs, outputs
    and per-pixel arithmetic, vectorised over all pixels and sequential over
    the position in the tile lists. Each step walks only the pixels that
    are not done and whose list is longer; it stops when none is left."""
    dev = ray_d.device
    gx = (W + TILE - 1) // TILE
    gy = (H + TILE - 1) // TILE
    N = B * H * W
    bi = torch.arange(B, device=dev)[:, None, None]
    yi = torch.arange(H, device=dev)[None, :, None]
    xi = torch.arange(W, device=dev)[None, None, :]
    tile = ((bi * gy + yi // TILE) * gx + xi // TILE).reshape(N)
    px = (xi * 16 + 8).expand(B, H, W).reshape(N)
    py = (yi * 16 + 8).expand(B, H, W).reshape(N)
    start = starts.long()[tile]
    count = (ends - starts).long()[tile]
    d = ray_d.reshape(N, 3)

    T = torch.ones(N, dtype=torch.float32, device=dev)
    pT = torch.ones(N, dtype=torch.float32, device=dev)
    C = torch.zeros(N, 3, dtype=torch.float32, device=dev)
    D = torch.zeros(N, dtype=torch.float32, device=dev)
    nc = torch.zeros(N, dtype=torch.int32, device=dev)
    live = torch.arange(N, device=dev)
    k = 0
    while True:
        live = live[(count[live] > k) & ~(T[live] < T_EPS)]
        if live.numel() == 0:
            break
        row = slot_face[start[live] + k].long()
        f = face_f32[row]
        e = face_i32[row].long()
        s_neg = [edge_value(e[:, i], e[:, 3 + i], e[:, 6 + i], px[live],
                            py[live]) < 0 for i in range(3)]
        cover = s_neg[0] & s_neg[1] & s_neg[2] & (f[:, _NONDEG] > 0)

        dx, dy, dz = d[live, 0], d[live, 1], d[live, 2]
        e1x, e1y, e1z = f[:, _E1], f[:, _E1 + 1], f[:, _E1 + 2]
        e2x, e2y, e2z = f[:, _E2], f[:, _E2 + 1], f[:, _E2 + 2]
        Px = dy * e2z - dz * e2y
        Py = dz * e2x - dx * e2z
        Pz = dx * e2y - dy * e2x
        denom = Px * e1x + Py * e1y + Pz * e1z
        valid = denom != 0.0
        inv = torch.reciprocal(torch.where(valid, denom, 1.0))
        u = (Px * f[:, _TV] + Py * f[:, _TV + 1] + Pz * f[:, _TV + 2]) * inv
        v = (f[:, _QV] * dx + f[:, _QV + 1] * dy + f[:, _QV + 2] * dz) * inv
        i1, i2, _code = clamp_bary_uv(u, v)
        i0 = 1.0 - i1 - i2
        inten = f[:, _INTEN]
        col = torch.stack([
            (i0 * f[:, _C0 + ch] + i1 * f[:, _C0 + 3 + ch]
             + i2 * f[:, _C0 + 6 + ch]) * inten for ch in range(3)], dim=-1)
        dep = (i0 * f[:, _D0] + i1 * f[:, _D0 + 1] + i2 * f[:, _D0 + 2])

        hit = cover & valid
        a = f[:, _ALPHA]
        Tl = T[live]
        w = torch.where(hit, a * Tl, 0.0)
        C[live] = C[live] + col * w[:, None]
        D[live] = D[live] + dep * w
        pT[live] = torch.where(hit, Tl, pT[live])
        T[live] = torch.where(hit, Tl * (1.0 - a), Tl)
        nc[live] = torch.where(hit, k + 1, nc[live]).to(torch.int32)
        k += 1

    C = C.reshape(B, H, W, 3).permute(0, 3, 1, 2)
    shape = (B, H, W)
    return C, D.reshape(shape), T.reshape(shape), pT.reshape(shape), \
        nc.reshape(shape)


def render_tri_binned(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                      inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg,
                      height: int, width: int, kcap: int | None = None,
                      with_aux: bool = False, run_cap: int | None = None):
    """Tile-binned tri renderer, forward only.

    ``kcap``: (face, tile) key capacity (None: ``default_key_capacity``);
    ``run_cap``: (face, tile-row) run capacity (None: heuristic). Pairs
    past a capacity are dropped farthest first (see ops/binning.py).
    Returns (color [B, 3, H, W], depth [B, 1, H, W]) and, with
    ``with_aux``, ``(overflow bool[], num_rendered int[])``."""
    if faces.shape[0] == 0:
        raise ValueError(
            "render_tri_binned requires at least one face; the strategy "
            "dispatch (ops.tri.render_tri_auto, used by api.render_tri) "
            "routes empty/small scenes to the dense oracle path")
    B = mv_t.shape[0]
    if kcap is None:
        kcap = default_key_capacity(B, faces.shape[0])
    gx = (width + TILE - 1) // TILE
    gy = (height + TILE - 1) // TILE

    ndc, img = project_verts(verts, mv_t, proj_t, width, height)
    pre = preprocess_faces(ndc, img, faces, width, height, TILE, TILE)
    keys = emit_and_sort(pre, gx, gy, kcap, tile_px=TILE, run_cap=run_cap)
    face_f32, face_i32 = build_face_table(
        verts, faces, verts_color, faces_opacity, verts_depth, faces_intense,
        img, inv_mv_t[:, 3, :3])
    _ray_o, ray_d = generate_rays(inv_mv_t, inv_proj_t, width, height)
    C, D, T, _pT, _nc = fwd_composite(
        keys.starts, keys.ends, keys.slot_face, face_f32[keys.sigma],
        face_i32[keys.sigma], ray_d, B, height, width)
    color = C + T[:, None] * bg[None, :, None, None]
    depth = (D + T * 1.0)[:, None]
    if with_aux:
        return color, depth, (keys.overflow, keys.total)
    return color, depth
