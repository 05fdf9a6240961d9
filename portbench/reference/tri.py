"""Plain-torch reference of the tri renderer: forward, and gradients by
autograd.

Semantics (the renderer's contract): faces are culled and given a depth key
and a 32-px tile rect per view; every face is tested against the pixels of
the tiles in its rect, in the order of its depth key (ties by face index);
a pixel blends each face whose fixed-point coverage test (top-left rule,
wrapped int32 edge functions) passes and whose plane the ray meets, front
to back, ``w = alpha * T``, and stops once ``T`` falls below ``T_EPS``. The
colour interpolates the corner colours by the clamped barycentrics of the
ray's hit, times the face's intensity; the depth interpolates the corner
depths. Background and depth 1 fill what ``T`` leaves.

This implementation bins the faces by tile itself (every (tile, face) pair
of each rect, sorted by depth rank), then walks each tile's list in chunks
of positions, vectorised over the tiles that still have a pixel blending,
their pixels and the chunk's positions, sequential over the positions for
the blend. Gradients (vertex positions, vertex colours, face opacities)
come from autograd through that walk, checkpointed per chunk so that the
memory stays that of a forward; the one piece autograd cannot give is the
vertex positions' (u, v) chain, where the renderer's contract is the
reference renderer's analytic formulas (``_RayUV``).

``shade`` sets the dtype of the shading and the blend (barycentrics,
colours, opacities, transmittance, accumulators): float32 is the reference,
bfloat16 the benchmark's control. Coverage and intersection stay float32.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .geometry import (
    BIN_TILE,
    T_EPS,
    clamp_bary_uv,
    generate_rays,
    inverse44,
    preprocess_faces,
    project_verts,
    ray_tri_intersection,
    ray_tri_uv_grads_reference,
    wrap_i32,
)

CHUNK = 16          # list positions per chunk
_PAIR_BUDGET = 1 << 23  # (tile, position, pixel) elements per chunk at most


class _RayUV(torch.autograd.Function):
    """(u, v) of Moller-Trumbore for rays [..., 3] against triangles
    (p0, p1, p2 [..., 3], broadcast), with the reference renderer's
    gradients w.r.t. the corners (``ray_tri_uv_grads_reference``)."""

    @staticmethod
    def forward(ctx, ray_o, ray_d, p0, p1, p2):
        tuv, _nd = ray_tri_intersection(ray_o, ray_d, p0, p1, p2)
        ctx.save_for_backward(ray_o, ray_d, p0, p1, p2)
        return tuv[..., 1], tuv[..., 2]

    @staticmethod
    def backward(ctx, gu, gv):
        ray_o, ray_d, p0, p1, p2 = ctx.saved_tensors
        grads = ray_tri_uv_grads_reference(ray_o, ray_d, p0, p1, p2)
        live = ((gu != 0) | (gv != 0))[..., None]
        out = []
        for p, du, dv in zip((p0, p1, p2), grads[:3], grads[3:]):
            g = torch.where(live, gu[..., None] * du + gv[..., None] * dv, 0.0)
            # sum over the broadcast dims back to the corner's shape
            while g.dim() > p.dim():
                g = g.sum(0)
            for d in range(g.dim()):
                if p.shape[d] == 1 and g.shape[d] != 1:
                    g = g.sum(d, keepdim=True)
            out.append(g)
        return (None, None, *out)


def _bin(verts, faces, mv_t, proj_t, H, W):
    """One view's tile lists: (table [tiles, L] int64 face ids in depth
    order, -1 past each list's end, lengths [tiles], pre)."""
    F = faces.shape[0]
    gx, gy = (W + BIN_TILE - 1) // BIN_TILE, (H + BIN_TILE - 1) // BIN_TILE
    ndc, img = project_verts(verts, mv_t, proj_t, W, H)
    pre = preprocess_faces(ndc, img, faces, W, H, BIN_TILE, BIN_TILE)
    valid = pre["valid"][0]
    key = torch.where(valid, pre["depth"][0], float("inf"))
    order = torch.sort(key, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(F, device=order.device)
    rmin, rmax = pre["rect_min"][0].long(), pre["rect_max"][0].long()
    nx = (rmax[:, 0] - rmin[:, 0]).clamp_min(0)
    ny = (rmax[:, 1] - rmin[:, 1]).clamp_min(0)
    cnt = torch.where(valid, nx * ny, 0)
    face = torch.repeat_interleave(torch.arange(F, device=cnt.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(face.numel(), device=cnt.device) - first[face]
    tx = rmin[face, 0] + k % nx[face]
    ty = rmin[face, 1] + k // nx[face]
    tile = ty * gx + tx
    s = torch.sort(tile * F + rank[face]).indices
    tile, face = tile[s], face[s]
    n_tiles = gx * gy
    lengths = torch.bincount(tile, minlength=n_tiles)
    starts = torch.cumsum(lengths, 0) - lengths
    L = int(lengths.max()) if face.numel() else 0
    table = torch.full((n_tiles, max(L, 1)), -1, dtype=torch.long,
                       device=cnt.device)
    table[tile, torch.arange(face.numel(), device=cnt.device)
          - starts[tile]] = face
    return table, lengths, pre


def _pixels(H, W, dev):
    """Per tile its pixels' (x, y) [tiles, P] and whether each is inside
    the image."""
    gx, gy = (W + BIN_TILE - 1) // BIN_TILE, (H + BIN_TILE - 1) // BIN_TILE
    t = torch.arange(gx * gy, device=dev)[:, None]
    i = torch.arange(BIN_TILE * BIN_TILE, device=dev)[None]
    x = (t % gx) * BIN_TILE + i % BIN_TILE
    y = (t // gx) * BIN_TILE + i // BIN_TILE
    return x, y, (x < W) & (y < H)


class _View:
    """The per-view constants of the walk (no gradient)."""

    def __init__(self, verts, faces, mv_t, proj_t, vdepth, finten, H, W):
        dev = verts.device
        with torch.no_grad():
            inv = inverse44(torch.stack([mv_t, proj_t]))
            ray_o, ray_d = generate_rays(inv[0], inv[1], W, H, "tri")
            self.table, self.lengths, pre = _bin(verts.detach(), faces, mv_t,
                                                 proj_t, H, W)
            self.edges = [torch.stack([pre[k][e][0].long() for e in range(3)])
                          for k in ("edge_a", "edge_b", "edge_c")]
            self.nondeg = pre["nondeg"][0]
            self.n_valid = int(pre["valid"][0].sum())
            x, y, self.inside = _pixels(H, W, dev)
            self.x, self.y = x, y
            self.fx, self.fy = x * 16 + 8, y * 16 + 8  # fixed-point samples
            xc, yc = x.clamp(max=W - 1), y.clamp(max=H - 1)
            self.ray_d = ray_d[0][yc, xc]  # [tiles, P, 3]
            self.ray_o = ray_o[0, 0, 0]
        self.vdepth, self.finten = vdepth, finten


def _chunk(view, faces, verts, vcolor, fopac, shade, j0, K, act, T, C, D,
           done, counts):
    """Positions [j0, j0 + K) of the lists of tiles ``act``: the new (T, C,
    D, done) of those tiles."""
    fk = view.table[act, j0:j0 + K]  # [A, K]
    present = fk >= 0
    f = fk.clamp_min(0)
    px, py = view.fx[act][:, None], view.fy[act][:, None]  # [A, 1, P]
    cov = present[..., None] & view.nondeg[f][..., None] & \
        view.inside[act][:, None]
    for e in range(3):
        a, b, c = (view.edges[i][e][f][..., None] for i in range(3))
        val = wrap_i32(wrap_i32(wrap_i32(a * px) + wrap_i32(b * py)) + c)
        cov = cov & (val < 0)
    fv = faces[f].long()  # [A, K, 3]
    p = verts[fv][:, :, None]  # [A, K, 1, 3, 3]
    rd = view.ray_d[act][:, None]  # [A, 1, P, 3]
    with torch.no_grad():
        _tuv, nd = ray_tri_intersection(view.ray_o, rd, p[..., 0, :].detach(),
                                        p[..., 1, :].detach(),
                                        p[..., 2, :].detach())
    hit = cov & nd
    u, v = _RayUV.apply(view.ray_o, rd, p[..., 0, :], p[..., 1, :],
                        p[..., 2, :])
    u_c, v_c, _code = clamp_bary_uv(u, v)
    u_c, v_c = u_c.to(shade), v_c.to(shade)
    i0 = 1.0 - u_c - v_c
    col = vcolor.to(shade)[fv][:, :, None]  # [A, K, 1, 3 corners, 3 ch]
    icol = (i0[..., None] * col[..., 0, :] + u_c[..., None] * col[..., 1, :]
            + v_c[..., None] * col[..., 2, :])
    icol = icol * view.finten.to(shade)[f][:, :, None, None]
    dep = view.vdepth.to(shade)[fv][:, :, None]  # [A, K, 1, 3]
    idep = i0 * dep[..., 0] + u_c * dep[..., 1] + v_c * dep[..., 2]
    alpha = fopac.to(shade)[f]  # [A, K]
    Ta, Ca, Da, da = T[act], C[act], D[act], done[act]
    for k in range(fk.shape[1]):
        active = hit[:, k] & ~da
        a = alpha[:, k, None]
        w = torch.where(active, a * Ta, 0.0)
        Ca = Ca + icol[:, k] * w[..., None]
        Da = Da + idep[:, k] * w
        Ta = torch.where(active, Ta * (1.0 - a), Ta)
        da = da | (active & (Ta < T_EPS))
        if counts is not None:
            counts["hits"] += int(active.sum())
            newly = active & (Ta < T_EPS)
            counts["_stop"][act] = torch.where(
                newly, j0 + k + 1, counts["_stop"][act])
            counts["_last"][act] = torch.where(
                active, j0 + k + 1, counts["_last"][act])
    return (T.index_copy(0, act, Ta), C.index_copy(0, act, Ca),
            D.index_copy(0, act, Da), done.index_copy(0, act, da))


def render_view(verts, faces, vcolor, fopac, mv_t, proj_t, vdepth, finten,
                bg, H: int, W: int, shade=torch.float32, counts=None):
    """One view (mv_t, proj_t [1, 4, 4] transposed; vdepth [P];
    finten [F]): (color [3, H, W], depth [1, H, W], alpha [1, H, W]) in
    float32. Differentiable in verts, vcolor and fopac. ``counts``: a dict
    that receives the work these inputs need (module ``metrics._roofline``
    reads it)."""
    dev = verts.device
    view = _View(verts, faces, mv_t, proj_t, vdepth, finten, H, W)
    n_tiles, P = view.x.shape
    T = torch.ones(n_tiles, P, dtype=shade, device=dev)
    C = torch.zeros(n_tiles, P, 3, dtype=shade, device=dev)
    D = torch.zeros(n_tiles, P, dtype=shade, device=dev)
    done = ~view.inside
    if counts is not None:
        counts.setdefault("hits", 0)
        counts["_stop"] = torch.zeros(n_tiles, P, dtype=torch.long,
                                      device=dev)
        counts["_last"] = torch.zeros_like(counts["_stop"])
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (verts, vcolor, fopac))
    if grad and counts is not None:
        raise ValueError("counts are taken by a forward without gradients")
    L = view.table.shape[1]
    j0 = 0
    while j0 < L:
        live_tile = (view.lengths > j0) & ~done.all(dim=1)
        act = torch.nonzero(live_tile).squeeze(1)
        if act.numel() == 0:
            break
        K = max(1, min(CHUNK, _PAIR_BUDGET // max(1, act.numel() * P)))
        args = (view, faces, verts, vcolor, fopac, shade, j0, K, act, T, C,
                D, done, counts)
        if grad:
            T, C, D, done = checkpoint(_chunk, *args, use_reentrant=False)
        else:
            T, C, D, done = _chunk(*args)
        j0 += K
    if counts is not None:
        lengths = view.lengths[:, None].expand(n_tiles, P)
        stop = torch.where(counts["_stop"] > 0, counts["_stop"], lengths)
        inside = view.inside
        counts["pairs"] = counts.get("pairs", 0) + int(view.lengths.sum())
        counts["fwd_visits"] = counts.get("fwd_visits", 0) + int(
            stop[inside].sum())
        counts["bwd_visits"] = counts.get("bwd_visits", 0) + int(
            counts["_last"][inside].sum())
        counts["pixels"] = counts.get("pixels", 0) + int(inside.sum())
        counts["faces"] = counts.get("faces", 0) + view.n_valid
        del counts["_stop"], counts["_last"]
    bgc = bg.to(shade)
    color = C + T[..., None] * bgc
    depth = D + T
    alpha = 1.0 - T
    keep = view.inside.reshape(-1)

    def image(x, ch):
        x = x.reshape(n_tiles * P, ch)[keep]
        return _untile(x, view.x, view.y, H, W, ch)

    return (image(color, 3).float(), image(depth[..., None], 1).float(),
            image(alpha[..., None], 1).float())


def _untile(vals, x, y, H, W, ch):
    """Values [pixels inside, ch] in tile order -> [ch, H, W]."""
    inside = ((x < W) & (y < H)).reshape(-1)
    idx = (y.reshape(-1) * W + x.reshape(-1))[inside]
    out = torch.zeros(H * W, ch, dtype=vals.dtype, device=vals.device)
    out = out.index_copy(0, idx, vals)
    return out.t().reshape(ch, H, W)


def render(verts, faces, vcolor, fopac, mv_t, proj_t, vdepth, finten, bg,
           H: int, W: int, shade=torch.float32, counts=None):
    """Every view of a batch (mv_t, proj_t [B, 4, 4] transposed; vdepth
    [B, P]; finten [B, F]): (color [B, 3, H, W], depth [B, 1, H, W],
    alpha [B, 1, H, W])."""
    outs = [render_view(verts, faces, vcolor, fopac, mv_t[b:b + 1],
                        proj_t[b:b + 1], vdepth[b], finten[b], bg, H, W,
                        shade, counts)
            for b in range(mv_t.shape[0])]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))
