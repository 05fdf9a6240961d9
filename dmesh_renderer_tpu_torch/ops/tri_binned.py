"""Tile-binned tri renderer: the scaled path of the tri renderer.

A port of the JAX package's ``ops/tri_binned.py``. Forward:

  project_verts + preprocess_faces -> emit_and_sort (binning.py)
  -> depth-sorted per-face table (``build_face_table``)
  -> generate_rays -> ``fwd_composite`` (kernel K1, csrc/tri_fwd.cu)

``fwd_composite`` composites every 32x32 tile's depth-sorted face list
front to back per pixel: fixed-point coverage from the int32 edge
coefficients, permissive Moller-Trumbore from the per-face constants
T = o - p0, E1, E2, Q = T x E1, clamped barycentrics, colour x intensity
and vertex depth interpolation, and the blend with the T < 1e-4 early exit.
The kernel looks up each slot's face row itself (``slot_face``), so no
slot-scale attribute table is built.

Backward (``_RenderTriBinned``, an autograd Function that keeps the keys,
the sorted face tables, the rays and K1's state from the forward):

  ``bwd_composite`` (kernel K2, csrc/tri_bwd.cu): per 16x16 quarter of a
  tile, the reverse walk from the quarter's last contributor, with T
  rebuilt by division from prevT, suffix accumulators, the background term
  and the clamp + Moller-Trumbore chain, summed over the quarter's pixels
  into one 22-column record per (slot, quarter) of each tile's walked
  prefix (``walked_slots``: the slots up to the tile's last contributor;
  the records of later slots would be zero and are not written), the
  prefixes packed tile after tile
  -> ``reduce_records``: segment sums (ops/reduce.py) to depth-sorted rows,
  back to (view, face) through ``sigma``, over views, and to the vertices.

Every sum has a fixed order, so the gradients are bitwise deterministic.

Every tensor of a frame is sized from B, F, H, W and the capacities, never
from the scene (the records at the slot capacity, the walked total kept on
the device), and the frame reads one value on the host: the overflow flag
with the pair and run totals that word its warning, after the forward
(``binning.warn_if_overflow``), and none while a CUDA graph is being
captured. So a frame, or a whole train step, can be
captured and replayed (``models.dmesh.make_train_step``).

The face table is compact: [B*F, 27] f32 (TV, E1, E2, Q, 9 corner colours,
3 vertex depths, opacity, intensity, nondeg) and [B*F, 9] int32 edge
coefficients (A1 A2 A3 B1 B2 B3 C1 C2 C3), rows in the per-view
depth-sorted order of ``BinnedKeys.slot_face``.
"""

from __future__ import annotations


import torch
from torch.autograd.function import once_differentiable

from ..kernels import launch
from ..utils import spans
from ..utils.config import BIN_TILE, T_EPS
from .binning import (
    default_key_capacity,
    emit_and_sort,
    owners,
    run_capacity,
    warn_if_overflow,
)
from .geometry import (
    clamp_bary_uv,
    clamp_bary_uv_grad,
    cross,
    edge_value,
    face_edge_coeffs,
    preprocess_faces,
    project_verts,
)
from .rays import generate_rays
from .reduce import faces_to_verts, seg_sum, segment_csr

TILE = BIN_TILE
QUAD = 16  # side of the pixel quarter one kernel block covers
FACE_F32_COLS = 27
FACE_I32_COLS = 9
# f32 face-table columns
_TV, _E1, _E2, _QV, _C0, _D0 = 0, 3, 6, 9, 12, 21
_ALPHA, _INTEN, _NONDEG = 24, 25, 26
# gradient-record columns: dL/dalpha, dL/dp0..dp2 (xyz each), the
# vertex-colour moments sum i_k dL/dcolor_c (k-major) and the vertex-depth
# moments sum i_k dL/ddepth
REC_COLS = 22
_G_ALPHA, _G_P, _G_VC, _G_VD = 0, 1, 10, 19


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
    tensors = [x.contiguous() for x in (starts, ends, slot_face, face_f32,
                                        face_i32, ray_d)]
    out = torch.empty((B, 6, H, W), dtype=torch.float32, device=ray_d.device)
    nc = torch.empty((B, H, W), dtype=torch.int32, device=ray_d.device)
    launch("tri_fwd", "tri_fwd_composite", tensors + [out, nc], [B, H, W],
           ray_d.device)
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


def _check_bwd_args(inputs, T, prevT, n_contrib, gin):
    _check_composite_args(*inputs)
    B, H, W = inputs[6:]
    dev = inputs[5].device
    for t, dtype, shape in ((T, torch.float32, (B, H, W)),
                            (prevT, torch.float32, (B, H, W)),
                            (n_contrib, torch.int32, (B, H, W)),
                            (gin, torch.float32, (B, 5, H, W))):
        if t.dtype != dtype:
            raise TypeError(f"bwd_composite: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"bwd_composite: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("bwd_composite: all tensors must share a device")


def walked_slots(starts, ends, n_contrib, B: int, H: int, W: int):
    """Each tile's walked prefix and its place in the compacted records.

    A tile's walk covers its list up to its last contributor: walked =
    min(list length, the largest n_contrib of its 32x32 pixels). Every
    later slot's records are zero, so ``bwd_composite`` writes only the
    walked prefixes, tile after tile. Returns (offs [n_tiles + 1] int32,
    the exclusive prefix sum of the walked counts, and their total Wk =
    offs[-1], a 0-d tensor on the device: nothing is read on the host)."""
    gx = (W + TILE - 1) // TILE
    gy = (H + TILE - 1) // TILE
    nc = n_contrib
    if gy * TILE != H or gx * TILE != W:
        nc = torch.nn.functional.pad(nc, (0, gx * TILE - W, 0, gy * TILE - H))
    tile_max = nc.reshape(B, gy, TILE, gx, TILE).amax(dim=(2, 4)).reshape(-1)
    walked = torch.minimum(ends - starts, tile_max)
    offs = walked.new_zeros(walked.numel() + 1)
    torch.cumsum(walked, 0, out=offs[1:])
    return offs, offs[-1]


def record_segments(slot_ids, slot_face, n_rows: int):
    """The depth-sorted face row of each record row, ``slot_face[slot_ids]``;
    ``n_rows`` (past every row, so ``segment_csr``'s offsets leave it out)
    for the sentinel id ``slot_face.numel()`` of the rows past the walked
    total, and for the slots past the live ones (``slot_face`` holds
    ``n_rows`` there)."""
    ext = torch.nn.functional.pad(slot_face, (0, 1), value=n_rows)
    return ext[slot_ids.long()]


def bwd_composite(starts, ends, slot_face, face_f32, face_i32, ray_d, T,
                  prevT, n_contrib, gin, B: int, H: int, W: int,
                  walked=None):
    """Gradient records of the composite's walked slots (kernel K2).

    The first nine arguments are ``fwd_composite``'s inputs; T, prevT and
    n_contrib [B, H, W] are its outputs; gin [B, 5, H, W] f32 holds per
    pixel (dL/dC rgb, dL/dD, bg . dL/dC + dL/dD). Returns (records
    [S, 4, REC_COLS] f32, slot_ids [S] int32), S = ``slot_face.numel()``,
    the static slot capacity. Row i < Wk (``walked_slots``' total) holds the
    slot ``slot_ids[i]`` of a tile's walked prefix (tiles in
    order, each prefix in slot order, so ``slot_ids`` increases), and for
    quarter q (the 16x16 quarter (q // 2, q % 2) of the slot's tile) the
    sums over the quarter's pixels of dL/dalpha, dL/dp0..dp2 (9), the
    vertex-colour moments sum i_k dL/dcolor_c (9, k-major) and the
    vertex-depth moments sum i_k dL/ddepth (3). A walked slot that no pixel
    of a quarter blended has zeros there. The slots past a tile's walked
    prefix have no row: their records would be zero. The rows from Wk on
    are not written (the plain version leaves zeros) and their slot id is
    the sentinel S (``record_segments``), so the reduce never reads them.
    ``walked``: ``walked_slots``' (offs, total) of these inputs, where the
    caller has them.

    On CUDA tensors this launches the kernel of csrc/tri_bwd.cu (and raises
    if it cannot); on CPU tensors it runs ``bwd_composite_plain``."""
    inputs = (starts, ends, slot_face, face_f32, face_i32, ray_d, B, H, W)
    _check_bwd_args(inputs, T, prevT, n_contrib, gin)
    if ray_d.device.type == "cpu":
        return bwd_composite_plain(starts, ends, slot_face, face_f32,
                                   face_i32, ray_d, T, prevT, n_contrib, gin,
                                   B, H, W)
    if ray_d.device.type != "cuda":
        raise ValueError(f"bwd_composite: unsupported device {ray_d.device}")
    tensors = [x.contiguous() for x in (starts, ends, slot_face, face_f32,
                                        face_i32, ray_d, T, prevT, n_contrib,
                                        gin)]
    offs = (walked_slots(tensors[0], tensors[1], tensors[8], B, H, W)
            if walked is None else walked)[0]
    dev = ray_d.device
    cap = slot_face.numel()
    rec = torch.empty((cap, 4, REC_COLS), dtype=torch.float32, device=dev)
    slot_ids = torch.full((cap,), cap, dtype=torch.int32, device=dev)
    launch("tri_bwd", "tri_bwd_composite", tensors + [offs, rec, slot_ids],
           [B, H, W], dev)
    bwd_composite.launches += 1
    return rec, slot_ids


bwd_composite.launches = 0


def _quarters(x, B, H, W, fill):
    """[B, H, W] -> [B * qy * qx, 256]: the 16x16 quarters of the image
    (row-major, padded with ``fill``), pixels in block-thread order."""
    qy, qx = (H + QUAD - 1) // QUAD, (W + QUAD - 1) // QUAD
    pad = x.new_full((B, qy * QUAD, qx * QUAD), fill)
    pad[:, :H, :W] = x
    return pad.reshape(B, qy, QUAD, qx, QUAD).permute(0, 1, 3, 2, 4) \
        .reshape(B * qy * qx, QUAD * QUAD)


def block_sum(v):
    """[..., 256] -> [...]: the kernel's block sum, in its order: an xor
    butterfly over each warp's 32 lanes (offsets 16, 8, 4, 2, 1; lane 0's
    value), then the 8 warp sums added in warp order."""
    v = v.reshape(*v.shape[:-1], 8, 32)
    lane = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ off]
    w = v[..., 0]
    s = w[..., 0]
    for i in range(1, 8):
        s = s + w[..., i]
    return s


def bwd_composite_plain(starts, ends, slot_face, face_f32, face_i32, ray_d,
                        T, prevT, n_contrib, gin, B: int, H: int, W: int):
    """Plain torch version of ``bwd_composite``: the same per-pixel f32
    arithmetic and the same sum order, vectorised over the quarters and
    sequential over the slot position, walked from the back. Each step
    takes the quarters whose walk reaches it: positions below
    min(list length, the quarter's largest n_contrib). The records go to
    the same compacted rows as the kernel's; the rest stay zero."""
    dev = ray_d.device
    gx = (W + TILE - 1) // TILE
    gy = (H + TILE - 1) // TILE
    qy, qx = (H + QUAD - 1) // QUAD, (W + QUAD - 1) // QUAD
    NQ = B * qy * qx
    bi = torch.arange(B, device=dev)[:, None, None]
    yi = torch.arange(qy, device=dev)[None, :, None]
    xi = torch.arange(qx, device=dev)[None, None, :]
    tile = ((bi * gy + yi // 2) * gx + xi // 2).reshape(NQ)
    quarter = ((yi % 2) * 2 + xi % 2).expand(B, qy, qx).reshape(NQ)
    ty, tx = torch.meshgrid(torch.arange(QUAD, device=dev),
                            torch.arange(QUAD, device=dev), indexing="ij")
    px = ((xi.reshape(1, 1, qx, 1, 1) * QUAD + tx) * 16 + 8).expand(
        B, qy, qx, QUAD, QUAD).reshape(NQ, QUAD * QUAD)
    py = ((yi.reshape(1, qy, 1, 1, 1) * QUAD + ty) * 16 + 8).expand(
        B, qy, qx, QUAD, QUAD).reshape(NQ, QUAD * QUAD)

    d = [_quarters(ray_d[..., c], B, H, W, 0.0) for c in range(3)]
    fT = _quarters(T, B, H, W, 1.0)
    fpT = _quarters(prevT, B, H, W, 1.0)
    nc = _quarters(n_contrib, B, H, W, 0).long()  # 0 outside the image
    g = [_quarters(gin[:, c], B, H, W, 0.0) for c in range(5)]

    start = starts.long()[tile]
    count = (ends - starts).long()[tile]
    n_eff = torch.minimum(count, nc.max(dim=1).values)
    offs, _total = walked_slots(starts, ends, n_contrib, B, H, W)
    comp = offs.long()[tile]  # the quarter's tile's first compacted row
    cap = slot_face.numel()

    zeros = lambda: torch.zeros(NQ, QUAD * QUAD, dtype=torch.float32,
                                device=dev)
    st = {"T": fpT.clone(), "first": torch.ones_like(nc, dtype=torch.bool)}
    for k in ("la", "lr", "lg", "lb", "ld", "ar", "ag", "ab", "ad"):
        st[k] = zeros()
    rec = torch.zeros((cap, 4, REC_COLS), dtype=torch.float32, device=dev)
    # row offs[t] + p is slot starts[t] + p; the rows past the walked total
    # take the sentinel id cap
    tile_of, live, first, _total = owners((offs[1:] - offs[:-1]).long(), cap)
    slot_ids = torch.where(
        live, starts.long()[tile_of] + torch.arange(cap, device=dev)
        - first[tile_of], cap).to(torch.int32)

    n_max = int(n_eff.max()) if NQ else 0
    for pos in range(n_max - 1, -1, -1):
        L = torch.nonzero(n_eff > pos).squeeze(1)
        row = slot_face[start[L] + pos].long()
        f = face_f32[row][:, :, None]  # [nL, 27, 1]: per-face scalars
        e = face_i32[row].long()
        s = {k: v[L] for k, v in st.items()}
        vals, new, live = _bwd_pixel_math(
            f, e, px[L], py[L], [x[L] for x in d], fT[L], fpT[L],
            pos < nc[L], [x[L] for x in g], s)
        for k, v in new.items():
            st[k][L] = v
        sums = block_sum(vals)  # [nL, 20]
        rec[comp[L] + pos, quarter[L]] = torch.where(
            live[:, None], _record_from_sums(sums, f[..., 0]), 0.0)
    return rec, slot_ids


def _bwd_pixel_math(f, e, px, py, d, fT, fpT, before_nc, g, s):
    """One slot of the reverse walk for [nL, 256] pixels: coverage, the
    active mask, the state update and the 20 per-pixel values that the
    block sums (dalpha, the seven Moller-Trumbore moments S(b), S(a d),
    S(c d), the nine colour and three depth moments). ``f`` [nL, 27, 1] is
    the slot's face row. Returns (vals [nL, 20, 256], the new state, and
    whether any pixel of each quarter is active [nL])."""
    dx, dy, dz = d
    g_r, g_g, g_b, g_d, bg_dot = g
    cover = f[:, _NONDEG] > 0
    for i in range(3):
        cover = cover & (edge_value(e[:, i, None], e[:, 3 + i, None],
                                    e[:, 6 + i, None], px, py) < 0)
    e1x, e1y, e1z = f[:, _E1], f[:, _E1 + 1], f[:, _E1 + 2]
    e2x, e2y, e2z = f[:, _E2], f[:, _E2 + 1], f[:, _E2 + 2]
    tvx, tvy, tvz = f[:, _TV], f[:, _TV + 1], f[:, _TV + 2]
    qx, qy, qz = f[:, _QV], f[:, _QV + 1], f[:, _QV + 2]
    Px = dy * e2z - dz * e2y
    Py = dz * e2x - dx * e2z
    Pz = dx * e2y - dy * e2x
    denom = Px * e1x + Py * e1y + Pz * e1z
    valid = denom != 0.0
    inv = torch.reciprocal(torch.where(valid, denom, 1.0))
    u = (Px * tvx + Py * tvy + Pz * tvz) * inv
    v = (qx * dx + qy * dy + qz * dz) * inv
    i1, i2, code = clamp_bary_uv(u, v)
    i0 = 1.0 - i1 - i2
    active = cover & valid & before_nc

    a = f[:, _ALPHA]
    one_m_a = torch.clamp_min(1.0 - a, 1e-30)
    T = torch.where(active & ~s["first"], s["T"] / one_m_a, s["T"])
    c = [f[:, _C0 + k] for k in range(9)]
    dd = [f[:, _D0 + k] for k in range(3)]
    inten = f[:, _INTEN]
    cr = (i0 * c[0] + i1 * c[3] + i2 * c[6]) * inten
    cg = (i0 * c[1] + i1 * c[4] + i2 * c[7]) * inten
    cb = (i0 * c[2] + i1 * c[5] + i2 * c[8]) * inten
    dep = i0 * dd[0] + i1 * dd[1] + i2 * dd[2]
    la = s["la"]
    ar_n = la * s["lr"] + (1.0 - la) * s["ar"]
    ag_n = la * s["lg"] + (1.0 - la) * s["ag"]
    ab_n = la * s["lb"] + (1.0 - la) * s["ab"]
    ad_n = la * s["ld"] + (1.0 - la) * s["ad"]

    aT = a * T
    dic_r, dic_g, dic_b, did = g_r * aT, g_g * aT, g_b * aT, g_d * aT
    dalpha = ((cr - ar_n) * g_r + (cg - ag_n) * g_g + (cb - ab_n) * g_b
              + (dep - ad_n) * g_d) * T
    bg_coef = torch.where(a == 1.0, -fpT, -fT / one_m_a)
    dalpha = dalpha + bg_coef * bg_dot

    cu = [(c[3 + k] - c[k]) * inten for k in range(3)]
    cv = [(c[6 + k] - c[k]) * inten for k in range(3)]
    dL_duc = (cu[0] * dic_r + cu[1] * dic_g + cu[2] * dic_b
              + (dd[1] - dd[0]) * did)
    dL_dvc = (cv[0] * dic_r + cv[1] * dic_g + cv[2] * dic_b
              + (dd[2] - dd[0]) * did)
    duc_du, duc_dv, dvc_du, dvc_dv = clamp_bary_uv_grad(code)
    dL_du = dL_duc * duc_du + dL_dvc * dvc_du
    dL_dv = dL_duc * duc_dv + dL_dvc * dvc_dv

    den2 = denom * denom
    inv2 = torch.reciprocal(torch.where(den2 == 0.0, 1.0, den2))
    v0 = u * denom
    v2n = qx * e2x + qy * e2y + qz * e2z
    a_m = -(dL_du * v0 + dL_dv * v2n) * inv2
    b_m = dL_dv * denom * inv2
    c_m = dL_du * denom * inv2

    vals = torch.stack([
        dalpha, b_m, a_m * dx, a_m * dy, a_m * dz, c_m * dx, c_m * dy,
        c_m * dz,
        i0 * dic_r, i0 * dic_g, i0 * dic_b, i1 * dic_r, i1 * dic_g,
        i1 * dic_b, i2 * dic_r, i2 * dic_g, i2 * dic_b,
        i0 * did, i1 * did, i2 * did], dim=1)
    vals = torch.where(active[:, None], vals, 0.0)

    m = active
    new = {
        "T": T, "first": s["first"] & ~m,
        "la": torch.where(m, a, la),
        "lr": torch.where(m, cr, s["lr"]), "lg": torch.where(m, cg, s["lg"]),
        "lb": torch.where(m, cb, s["lb"]), "ld": torch.where(m, dep, s["ld"]),
        "ar": torch.where(m, ar_n, s["ar"]),
        "ag": torch.where(m, ag_n, s["ag"]),
        "ab": torch.where(m, ab_n, s["ab"]),
        "ad": torch.where(m, ad_n, s["ad"]),
    }
    return vals, new, active.any(dim=1)


def _record_from_sums(S, f):
    """[nL, 20] block sums + the face rows [nL, 27] -> records [nL, 22]:
    dalpha, dL/dp0..dp2 rebuilt from the moments, the colour and depth
    moments. S(w (d x e2)) = S(w d) x e2 and the like."""
    S_b = S[:, 1]
    S_ax, S_ay, S_az = S[:, 2], S[:, 3], S[:, 4]
    S_cx, S_cy, S_cz = S[:, 5], S[:, 6], S[:, 7]
    e1x, e1y, e1z = f[:, _E1], f[:, _E1 + 1], f[:, _E1 + 2]
    e2x, e2y, e2z = f[:, _E2], f[:, _E2 + 1], f[:, _E2 + 2]
    tvx, tvy, tvz = f[:, _TV], f[:, _TV + 1], f[:, _TV + 2]
    qx, qy, qz = f[:, _QV], f[:, _QV + 1], f[:, _QV + 2]
    aRx = S_ay * e2z - S_az * e2y
    aRy = S_az * e2x - S_ax * e2z
    aRz = S_ax * e2y - S_ay * e2x
    cRx = S_cy * e2z - S_cz * e2y
    cRy = S_cz * e2x - S_cx * e2z
    cRz = S_cx * e2y - S_cy * e2x
    aEx = e1y * S_az - e1z * S_ay
    aEy = e1z * S_ax - e1x * S_az
    aEz = e1x * S_ay - e1y * S_ax
    cXx = tvy * S_cz - tvz * S_cy
    cXy = tvz * S_cx - tvx * S_cz
    cXz = tvx * S_cy - tvy * S_cx
    e2xtx = e2y * tvz - e2z * tvy
    e2xty = e2z * tvx - e2x * tvz
    e2xtz = e2x * tvy - e2y * tvx
    e12x = e1y * e2z - e1z * e2y
    e12y = e1z * e2x - e1x * e2z
    e12z = e1x * e2y - e1y * e2x
    gp1 = [aRx + S_b * e2xtx, aRy + S_b * e2xty, aRz + S_b * e2xtz]
    gp2 = [cXx + aEx + S_b * qx, cXy + aEy + S_b * qy, cXz + aEz + S_b * qz]
    gt = [cRx + S_b * e12x, cRy + S_b * e12y, cRz + S_b * e12z]
    gp0 = [-gp1[i] - gp2[i] - gt[i] for i in range(3)]
    return torch.cat([torch.stack([S[:, 0], *gp0, *gp1, *gp2], dim=1),
                      S[:, 8:]], dim=1)


def upstream_planes(dL_dcolor, dL_ddepth, bg):
    """``bwd_composite``'s gin [B, 5, H, W] from dL/dcolor [B, 3, H, W],
    dL/ddepth [B, 1, H, W] and bg [3]: rgb, depth, bg . dL/dC + dL/dD."""
    gdep = dL_ddepth[:, 0]
    bg_dot = (bg[0] * dL_dcolor[:, 0] + bg[1] * dL_dcolor[:, 1]
              + bg[2] * dL_dcolor[:, 2]) + gdep
    return torch.stack([dL_dcolor[:, 0], dL_dcolor[:, 1], dL_dcolor[:, 2],
                        gdep, bg_dot], dim=1)


def reduce_records(rec, slot_ids, slot_face, sigma, face_f32_sorted, faces,
                   faces_intense, n_verts: int):
    """Compacted records -> the five gradients.

    ``rec`` [Wk, 4, 22] and ``slot_ids`` [Wk] from ``bwd_composite``;
    ``slot_face`` and ``sigma`` the forward's ``BinnedKeys`` fields;
    ``face_f32_sorted`` the depth-sorted face table the kernels read;
    faces [F, 3]; faces_intense [B, F]. ``records_to_faces``, then
    ``faces_to_verts``. Returns (g_verts [P, 3], g_vcolor [P, 3],
    g_fopacity [F], g_vdepth [B, P], g_fintense [B, F])."""
    g_fopacity, g_p, g_vc, g_vd, g_fintense = records_to_faces(
        rec, slot_ids, slot_face, sigma, face_f32_sorted, faces_intense)
    g_verts, g_vcolor, g_vdepth = faces_to_verts(faces, n_verts, g_p, g_vc,
                                                 g_vd)
    return g_verts, g_vcolor, g_fopacity, g_vdepth, g_fintense


def records_to_faces(rec, slot_ids, slot_face, sigma, face_f32_sorted,
                     faces_intense):
    """The record reduce: records summed per depth-sorted row in slot
    order (segment sum over the record rows, keyed by
    ``record_segments``: the rows past the walked total are left out),
    un-permuted to (view, face) through ``sigma``, and summed over views
    where the parameter is shared.

    The slots that have no row hold zero records, and every sum starts at
    +0.0, so it never is -0.0 and adding +-0.0 leaves it as it is: the
    result is bitwise the reduce of the full [S, 4, 22] layout, with
    ``slot_ids`` = arange(S).
    Returns (g_fopacity [F], g_p [F, 3, 3], g_vc [F, 3, 3] per face corner,
    g_vd [B, F, 3], g_fintense [B, F])."""
    B, F = faces_intense.shape
    csr = segment_csr(record_segments(slot_ids, slot_face, B * F), B * F,
                      inner=4)
    g = seg_sum(rec.reshape(-1, REC_COLS), csr)  # [B*F, 22], sorted rows
    # dL/dintensity = sum_k,c colour[k, c] * (sum_p i_k dL/dcolor_c), the
    # nine products added in order
    prod = face_f32_sorted[:, _C0:_C0 + 9] * g[:, _G_VC:_G_VC + 9]
    gint = prod[:, 0]
    for j in range(1, 9):
        gint = gint + prod[:, j]
    g = torch.cat([g, gint[:, None]], dim=1)
    face_g = torch.empty_like(g).index_copy_(0, sigma, g) \
        .reshape(B, F, REC_COLS + 1)
    g_fopacity = face_g[..., _G_ALPHA].sum(0)
    g_p = face_g[..., _G_P:_G_P + 9].sum(0).reshape(F, 3, 3)
    g_vc = (face_g[..., _G_VC:_G_VC + 9] * faces_intense[..., None]) \
        .sum(0).reshape(F, 3, 3)
    g_vd = face_g[..., _G_VD:_G_VD + 3]
    g_fintense = face_g[..., REC_COLS]
    return g_fopacity, g_p, g_vc, g_vd, g_fintense


def _forward(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
             inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg,
             height, width, kcap, run_cap):
    """The binned forward: (color, depth, keys, the kernels' inputs and K1's
    state), the last two being what the backward needs."""
    if faces.shape[0] == 0:
        raise ValueError(
            "render_tri_binned requires at least one face; the strategy "
            "dispatch (ops.tri.render_tri_auto, used by api.render_tri) "
            "routes empty/small scenes to the dense oracle path")
    B = mv_t.shape[0]
    if kcap is None:
        kcap = default_key_capacity(B, faces.shape[0])
    run_cap = run_capacity(B * faces.shape[0], kcap, run_cap)
    gx = (width + TILE - 1) // TILE
    gy = (height + TILE - 1) // TILE

    ndc, img = project_verts(verts, mv_t, proj_t, width, height)
    pre = preprocess_faces(ndc, img, faces, width, height, TILE, TILE)
    spans.mark("tri.project")
    keys = emit_and_sort(pre, gx, gy, kcap, tile_px=TILE, run_cap=run_cap)
    spans.mark("tri.binning", keys.total)
    face_f32, face_i32 = build_face_table(
        verts, faces, verts_color, faces_opacity, verts_depth, faces_intense,
        img, inv_mv_t[:, 3, :3])
    _ray_o, ray_d = generate_rays(inv_mv_t, inv_proj_t, width, height)
    inputs = (keys.starts, keys.ends, keys.slot_face, face_f32[keys.sigma],
              face_i32[keys.sigma], ray_d, B, height, width)
    # the binning's run count, beside its table's capacity (the binning's
    # own mark carries its pair count)
    spans.mark("tri.prep", keys.runs, capacity=run_cap)
    C, D, T, pT, nc = fwd_composite(*inputs)
    color = C + T[:, None] * bg[None, :, None, None]
    depth = (D + T * 1.0)[:, None]
    spans.mark("tri.k1")
    return color, depth, keys, inputs, (T, pT, nc)


class _RenderTriBinned(torch.autograd.Function):
    """The binned renderer as an autograd Function. The forward keeps the
    keys, the depth-sorted face tables, the rays and K1's state, so the
    backward neither projects, bins nor sorts again; the backward runs K2
    and the record reduce. Gradients for verts, verts_color,
    faces_opacity, verts_depth and faces_intense; None for faces, the
    matrices and bg."""

    @staticmethod
    def forward(ctx, verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg,
                height, width, kcap, run_cap):
        color, depth, keys, inputs, state = _forward(
            verts, faces, verts_color, faces_opacity, mv_t, proj_t,
            inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg, height,
            width, kcap, run_cap)
        ctx.save_for_backward(*inputs[:6], *state, keys.sigma, faces,
                              faces_intense, bg)
        ctx.n_verts = verts.shape[0]
        ctx.mark_non_differentiable(keys.overflow, keys.total, keys.runs)
        return color, depth, keys.overflow, keys.total, keys.runs

    @staticmethod
    @once_differentiable
    def backward(ctx, dL_dcolor, dL_ddepth, _d_overflow, _d_total, _d_runs):
        spans.mark("step.loss")
        (starts, ends, slot_face, ff, fi, ray_d, T, pT, nc, sigma, faces,
         faces_intense, bg) = ctx.saved_tensors
        B, H, W = T.shape
        gin = upstream_planes(dL_dcolor, dL_ddepth, bg)
        walked = walked_slots(starts, ends, nc, B, H, W)
        rec, slot_ids = bwd_composite(starts, ends, slot_face, ff, fi, ray_d,
                                      T, pT, nc, gin, B, H, W, walked)
        spans.mark("tri.k2", walked[1])
        g_verts, g_vcolor, g_fop, g_vdepth, g_fint = reduce_records(
            rec, slot_ids, slot_face, sigma, ff, faces, faces_intense,
            ctx.n_verts)
        spans.mark("tri.reduce")
        return (g_verts, None, g_vcolor, g_fop, None, None, None, None,
                g_vdepth, g_fint, None, None, None, None, None)


def render_tri_binned(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                      inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg,
                      height: int, width: int, kcap: int | None = None,
                      with_aux: bool = False, run_cap: int | None = None,
                      warn_overflow: bool = True, with_runs: bool = False):
    """Tile-binned tri renderer.

    ``kcap``: (face, tile) key capacity (None: ``default_key_capacity``);
    ``run_cap``: (face, tile-row) run capacity (None: heuristic). Pairs
    past a capacity are dropped farthest first (see ops/binning.py).
    Returns (color [B, 3, H, W], depth [B, 1, H, W]) and, with
    ``with_aux``, ``(overflow bool[], num_rendered int[])``, to which
    ``with_runs`` adds the (face, tile-row) run count (int64[]). With
    ``warn_overflow`` the overflow flag is read once after the forward and
    an overflow warns (never while a CUDA graph is being captured).

    Differentiable in verts, verts_color, faces_opacity, verts_depth and
    faces_intense when any of them requires grad; otherwise autograd
    records nothing and the forward's residuals are freed on return."""
    if kcap is None:
        kcap = default_key_capacity(mv_t.shape[0], faces.shape[0])
    run_cap = run_capacity(mv_t.shape[0] * faces.shape[0], kcap, run_cap)
    color, depth, overflow, total, runs = _RenderTriBinned.apply(
        verts, faces, verts_color, faces_opacity, mv_t, proj_t, inv_mv_t,
        inv_proj_t, verts_depth, faces_intense, bg, height, width, kcap,
        run_cap)
    if warn_overflow:
        warn_if_overflow(overflow, total, kcap, "render_tri_binned",
                         runs=runs, run_cap=run_cap,
                         settings="TriRenderSettings")
    if with_aux:
        return color, depth, (overflow, total) + ((runs,) if with_runs else ())
    return color, depth
