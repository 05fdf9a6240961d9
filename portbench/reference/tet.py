"""Plain-torch reference of the tet renderer: forward, and the gradients of
the vertex colours and face opacities by autograd.

Semantics (the renderer's contract): each pixel's ray (through the pixel
centre, the "tet" norm clamp) finds its first strict hit among the faces
whose 32-px tile rect holds the pixel's tile (the smallest ray parameter t;
of equal t the face first in per-view min-depth order, ties by face index);
it enters the tet behind that face (of the face's two tets the one whose
outward normal of that face opposes the ray, the second when both do), and
walks: it blends the current face (``w = T * alpha``, the corner colours
interpolated by the hit's (u, v), times the face's intensity; the
projective depth), updates ``log T`` by ``log(max(1 - alpha, 1e-37))`` (or
to the floor ``log(T_EPS * 0.1)`` at ``alpha >= 1``), and stops once ``T <
T_EPS`` or the tet is -1 (the ray left the mesh): such a ray is active.
Otherwise it leaves the tet through the one other face that it hits
strictly with a positive dot of the ray and that face's outward normal, and
moves into the neighbour across it; a walk that finds no such face, or more
than one, or an entry face it does not enter, breaks (inactive), as does a
ray that blends ``max_steps`` faces. Inactive pixels are the background
with depth 1.

The walk runs without gradients and records each ray's faces and hit
coordinates; the blend is then replayed over those records with autograd.
``shade`` sets the dtype of that blend (float32 the reference, bfloat16 the
benchmark's control); the walk stays float32.
"""

from __future__ import annotations

import math

import torch

from .geometry import (
    BIN_TILE,
    T_EPS,
    clamp_w,
    cross,
    generate_rays,
    inverse44,
    preprocess_faces,
    project_verts,
    sqrt_rn,
)

LOG_T_FLOOR = float(torch.tensor(math.log(T_EPS * 0.1),
                                 dtype=torch.float32))
MAX_STEPS = 512
_PAIR_BUDGET = 1 << 23


def _mt(p0, e1, e2, o, d):
    """Moller-Trumbore of rays (o, d) against (p0, e1, e2), 3-lists that
    broadcast: (t, u, v, denominator != 0)."""
    tv = [o[k] - p0[k] for k in range(3)]
    pv = [d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
          d[0] * e2[1] - d[1] * e2[0]]
    qv = [tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
          tv[0] * e1[1] - tv[1] * e1[0]]
    denom = pv[0] * e1[0] + pv[1] * e1[1] + pv[2] * e1[2]
    nd = denom != 0.0
    inv = torch.reciprocal(torch.where(nd, denom, 1.0))
    t = (qv[0] * e2[0] + qv[1] * e2[1] + qv[2] * e2[2]) * inv
    u = (pv[0] * tv[0] + pv[1] * tv[1] + pv[2] * tv[2]) * inv
    v = (qv[0] * d[0] + qv[1] * d[1] + qv[2] * d[2]) * inv
    return t, u, v, nd


def _first_hit(verts, faces, pre, cam_o, ray_d, H, W):
    """The first strict hit of every pixel of one view: (face [N] long, -1
    on a miss; t, u, v [N])."""
    dev = verts.device
    F = faces.shape[0]
    gx, gy = (W + BIN_TILE - 1) // BIN_TILE, (H + BIN_TILE - 1) // BIN_TILE
    n_tiles = gx * gy
    valid = pre["valid"][0]
    key = torch.where(valid, pre["min_depth"][0], math.inf)
    order = torch.sort(key, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(F, device=dev)
    rmin, rmax = pre["rect_min"][0].long(), pre["rect_max"][0].long()
    nx = (rmax[:, 0] - rmin[:, 0]).clamp_min(0)
    cnt = torch.where(valid, nx * (rmax[:, 1] - rmin[:, 1]).clamp_min(0), 0)
    face = torch.repeat_interleave(torch.arange(F, device=dev), cnt)
    k = torch.arange(face.numel(), device=dev) - (torch.cumsum(cnt, 0)
                                                  - cnt)[face]
    tile = ((rmin[face, 1] + k // nx[face]) * gx + rmin[face, 0]
            + k % nx[face])
    s = torch.sort(tile * F + rank[face]).indices
    tile, face = tile[s], face[s]
    lengths = torch.bincount(tile, minlength=n_tiles)
    starts = torch.cumsum(lengths, 0) - lengths
    L = int(lengths.max()) if face.numel() else 0
    table = torch.full((n_tiles, max(L, 1)), -1, dtype=torch.long, device=dev)
    table[tile, torch.arange(face.numel(), device=dev) - starts[tile]] = face

    P = BIN_TILE * BIN_TILE
    t_ = torch.arange(n_tiles, device=dev)[:, None]
    i_ = torch.arange(P, device=dev)[None]
    x = (t_ % gx) * BIN_TILE + i_ % BIN_TILE
    y = (t_ // gx) * BIN_TILE + i_ // BIN_TILE
    inside = (x < W) & (y < H)
    rd = ray_d[y.clamp(max=H - 1), x.clamp(max=W - 1)]  # [tiles, P, 3]
    gv = verts[faces.long()]
    p0, e1, e2 = gv[:, 0], gv[:, 1] - gv[:, 0], gv[:, 2] - gv[:, 0]

    big = torch.tensor(3.0e38, device=dev)
    bt = big.expand(n_tiles, P).clone()
    bface = torch.full((n_tiles, P), -1, dtype=torch.long, device=dev)
    bu = torch.zeros(n_tiles, P, device=dev)
    bv = torch.zeros(n_tiles, P, device=dev)
    j0 = 0
    while j0 < L:
        act = torch.nonzero(lengths > j0).squeeze(1)
        K = max(1, min(32, _PAIR_BUDGET // (act.numel() * P)))
        fk = table[act, j0:j0 + K]
        f = fk.clamp_min(0)
        d = [rd[act][:, None, :, c] for c in range(3)]  # [A, 1, P]
        col = lambda x, c: x[f][..., c][..., None]  # noqa: E731
        t, u, v, nd = _mt([col(p0, c) for c in range(3)],
                          [col(e1, c) for c in range(3)],
                          [col(e2, c) for c in range(3)],
                          [cam_o[c] for c in range(3)], d)
        hit = (nd & (t >= 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (fk >= 0)[..., None] & inside[act][:, None])
        kt = torch.where(hit, t, big)
        mt = kt.min(dim=1, keepdim=True).values
        cand = (hit & (kt <= mt)).to(torch.uint8).argmax(dim=1, keepdim=True)
        ct = kt.gather(1, cand)[:, 0]
        better = ct < bt[act]
        cf = f.gather(1, cand[:, 0])
        bt[act] = torch.where(better, ct, bt[act])
        bface[act] = torch.where(better, cf, bface[act])
        bu[act] = torch.where(better, u.gather(1, cand)[:, 0], bu[act])
        bv[act] = torch.where(better, v.gather(1, cand)[:, 0], bv[act])
        j0 += K
    keep = inside.reshape(-1)
    idx = (y * W + x).reshape(-1)[keep]
    out = []
    for val, fill in ((bface, -1), (torch.where(bt < big, bt, 0.0), 0.0),
                      (bu, 0.0), (bv, 0.0)):
        img = torch.full((H * W,), fill, dtype=val.dtype, device=dev)
        out.append(img.index_copy(0, idx, val.reshape(-1)[keep]))
    return out, int(lengths.sum())


def _tables(verts, faces, tets, tet_faces, face_tets):
    """Per face its plane rows; per tet its 4 slots' corner, edges, outward
    unit normal and neighbour, and the outward signs."""
    fl = faces.long()
    gv = verts[fl]
    p0 = gv[:, 0]
    e1 = gv[:, 1] - p0
    e2 = gv[:, 2] - p0
    n = cross(e1, e2)
    norm = sqrt_rn(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2])
    nhat = n / torch.maximum(norm, torch.full_like(norm, 1e-4))[:, None]
    T = tets.shape[0]
    tf = tet_faces.long().clamp_min(0)
    tv = verts[tets.long()]
    centers = (tv[:, 0] + tv[:, 1] + tv[:, 2] + tv[:, 3]) / torch.full_like(
        tv[:, 0], 4.0)
    off = centers[:, None, :] - p0[tf]
    nt = nhat[tf]
    flip = (nt[..., 0] * off[..., 0] + nt[..., 1] * off[..., 1]
            + nt[..., 2] * off[..., 2]) > 0.0
    sign = torch.where(flip, -1.0, 1.0)
    ft2 = face_tets.long()[tf]
    tidx = torch.arange(T, device=verts.device)[:, None]
    c0, c1 = ft2[..., 0], ft2[..., 1]
    nbr = torch.where((c0 != tidx) & (c0 != -1), c0,
                      torch.where((c1 != tidx) & (c1 != -1), c1, -1))
    return dict(p0=p0, e1=e1, e2=e2, nhat=nhat, sign=sign,
                slot_p0=p0[tf], slot_e1=e1[tf], slot_e2=e2[tf],
                slot_n=sign[..., None] * nt, slot_face=tet_faces.long(),
                slot_nbr=nbr)


def _start_tets(ff, ray_d, tab, face_tets, tet_faces):
    ffs = ff.clamp_min(0)
    nh = tab["nhat"][ffs]
    ndot = nh[:, 0] * ray_d[:, 0] + nh[:, 1] * ray_d[:, 1] \
        + nh[:, 2] * ray_d[:, 2]
    ftc = face_tets.long()[ffs]
    first = torch.full_like(ff, -1)
    for i in range(2):
        cand = ftc[:, i]
        cs = cand.clamp_min(0)
        cf, csg = tet_faces.long()[cs], tab["sign"][cs]
        sgn = torch.where(cf[:, 0] == ff, csg[:, 0], 0.0)
        for j in range(1, 4):
            sgn = sgn + torch.where(cf[:, j] == ff, csg[:, j], 0.0)
        take = (cand >= 0) & (sgn * ndot < 0.0) & (ff >= 0)
        first = torch.where(take, cand, first)
    return first


def _walk(tab, tet, cf, o, d):
    """One step for [L] rays in tets ``tet`` that stand on face ``cf``:
    (err, next face, next tet, t, u, v)."""
    n_other = torch.zeros_like(cf)
    n_exit = torch.zeros_like(cf)
    d_entry = torch.zeros(cf.shape, device=cf.device)
    sp0, se1, se2 = tab["slot_p0"][tet], tab["slot_e1"][tet], tab["slot_e2"][
        tet]
    sn, sf, sb = tab["slot_n"][tet], tab["slot_face"][tet], tab["slot_nbr"][
        tet]
    nxt = None
    for j in range(4):
        outd = sn[:, j, 0] * d[0] + sn[:, j, 1] * d[1] + sn[:, j, 2] * d[2]
        t, u, v, nd = _mt([sp0[:, j, k] for k in range(3)],
                          [se1[:, j, k] for k in range(3)],
                          [se2[:, j, k] for k in range(3)], o, d)
        hit = nd & (t >= 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        is_entry = sf[:, j] == cf
        n_other = n_other + (~is_entry).long()
        d_entry = d_entry + torch.where(is_entry, outd, 0.0)
        ex = ~is_entry & hit & (outd > 0.0)
        n_exit = n_exit + ex.long()
        if nxt is None:
            nxt = [t, u, v, sf[:, j], sb[:, j]]
        else:
            nxt = [torch.where(ex, a, b) for a, b in
                   zip((t, u, v, sf[:, j], sb[:, j]), nxt)]
    err = (n_other != 3) | (d_entry >= 0.0) | (n_exit != 1)
    return err, nxt[3], nxt[4], nxt[0], nxt[1], nxt[2]


def _march(tab, fopac, first_face, first_tet, tuv, cam_o, ray_d, max_steps):
    """The walk of one view's rays without gradients: the per-step records
    [(rays, faces, t, u, v)] and each ray's active flag."""
    dev = ray_d.device
    N = ray_d.shape[0]
    l1a = torch.log(torch.maximum(1.0 - fopac, torch.full_like(fopac, 1e-37)))
    log_T = torch.zeros(N, device=dev)
    active = torch.zeros(N, dtype=torch.bool, device=dev)
    cf, ct = first_face.clone(), first_tet.clone()
    t, u, v = (x.clone() for x in tuv)
    steps = []
    live = torch.nonzero((cf != -1) & (ct != -1)).squeeze(1)
    for _ in range(max_steps):
        if live.numel() == 0:
            break
        cfl, ctl = cf[live], ct[live]
        steps.append((live, cfl, t[live], u[live], v[live]))
        a = fopac[cfl]
        lt = torch.where(a < 1.0, log_T[live] + l1a[cfl], LOG_T_FLOOR)
        log_T[live] = lt
        term = (torch.exp(lt) < T_EPS) | (ctl == -1)
        active[live[term]] = True
        keep = ~term
        live, ctl, cfl = live[keep], ctl[keep], cfl[keep]
        d = [ray_d[live, k] for k in range(3)]
        err, nf, nt, t2, u2, v2 = _walk(tab, ctl, cfl, cam_o, d)
        ok = ~err
        live = live[ok]
        cf[live], ct[live] = nf[ok], nt[ok]
        t[live], u[live], v[live] = t2[ok], u2[ok], v2[ok]
    return steps, active


def _zw(cam_o, ray_d, mv_t, proj_t):
    """z and w of proj(mv(o + t d)) as (z0, w0, dz, dw) per ray [N]."""
    mv, pj = mv_t[0], proj_t[0]
    pvo = [cam_o[0] * mv[0, i] + cam_o[1] * mv[1, i] + cam_o[2] * mv[2, i]
           + mv[3, i] for i in range(3)]
    dv = [ray_d[:, 0] * mv[0, i] + ray_d[:, 1] * mv[1, i]
          + ray_d[:, 2] * mv[2, i] for i in range(3)]
    z0 = pvo[0] * pj[0, 2] + pvo[1] * pj[1, 2] + pvo[2] * pj[2, 2] + pj[3, 2]
    w0 = pvo[0] * pj[0, 3] + pvo[1] * pj[1, 3] + pvo[2] * pj[2, 3] + pj[3, 3]
    dz = dv[0] * pj[0, 2] + dv[1] * pj[1, 2] + dv[2] * pj[2, 2]
    dw = dv[0] * pj[0, 3] + dv[1] * pj[1, 3] + dv[2] * pj[2, 3]
    return z0.expand_as(dz), w0.expand_as(dz), dz, dw


def render_view(verts, faces, vcolor, fopac, mv_t, proj_t, finten, tets,
                face_tets, tet_faces, bg, H: int, W: int,
                max_steps: int = MAX_STEPS, shade=torch.float32,
                counts=None):
    """One view (mv_t, proj_t [1, 4, 4] transposed; finten [F]): (color
    [3, H, W], depth [1, H, W], active [H, W]) in float32, differentiable
    in vcolor and fopac. ``counts`` receives the work of the walk."""
    with torch.no_grad():
        inv = inverse44(torch.stack([mv_t, proj_t]))
        ray_o, ray_d = generate_rays(inv[0], inv[1], W, H, "tet")
        cam_o = inv[0][0, 3, :3]
        ndc, img = project_verts(verts, mv_t, proj_t, W, H)
        pre = preprocess_faces(ndc, img, faces, W, H, BIN_TILE, BIN_TILE)
        (ff, t0, u0, v0), pairs = _first_hit(verts, faces, pre, cam_o,
                                             ray_d[0], H, W)
        rd = ray_d[0].reshape(H * W, 3)
        tab = _tables(verts, faces, tets, tet_faces, face_tets)
        ft = _start_tets(ff, rd, tab, face_tets, tet_faces)
        steps, active = _march(tab, fopac.detach().float(), ff, ft,
                               (t0, u0, v0), [cam_o[k] for k in range(3)],
                               rd, max_steps)
        z0, w0, dz, dw = _zw(cam_o, rd, mv_t, proj_t)
    if counts is not None:
        n_rec = sum(int(active[s[0]].sum()) for s in steps)
        counts["records"] = counts.get("records", 0) + n_rec
        counts["rays"] = counts.get("rays", 0) + int(active.sum())
        counts["pixels"] = counts.get("pixels", 0) + H * W
        counts["pairs"] = counts.get("pairs", 0) + pairs
        counts["tets"] = tets.shape[0]
        counts["faces"] = faces.shape[0]
    N = H * W
    dev = verts.device
    fo = fopac.to(shade)
    l1a = torch.log(torch.maximum(1.0 - fo, torch.full_like(fo, 1e-37)))
    col3 = vcolor.to(shade)[faces.long()]  # [F, 3 corners, 3 ch]
    fi = finten.to(shade)
    C = torch.zeros(N, 3, dtype=shade, device=dev)
    D = torch.zeros(N, dtype=shade, device=dev)
    log_T = torch.zeros(N, dtype=shade, device=dev)
    T_cur = torch.ones(N, dtype=shade, device=dev)
    floor = torch.tensor(LOG_T_FLOOR, dtype=shade, device=dev)
    for rays, f, t, u, v in steps:
        a = fo[f]
        c = col3[f]
        uu, vv = u.to(shade)[:, None], v.to(shade)[:, None]
        colr = (c[:, 0] + (c[:, 1] - c[:, 0]) * uu
                + (c[:, 2] - c[:, 0]) * vv) * fi[f][:, None]
        w = T_cur[rays] * a
        C = C.index_add(0, rays, colr * w[:, None])
        dep = ((z0[rays] + t * dz[rays])
               / clamp_w(w0[rays] + t * dw[rays])).to(shade)
        D = D.index_add(0, rays, dep * w)
        lt = torch.where(a < 1.0, log_T[rays] + l1a[f], floor)
        log_T = log_T.index_copy(0, rays, lt)
        T_cur = T_cur.index_copy(0, rays, torch.exp(lt))
    bgc = bg.to(shade)
    color = torch.where(active[:, None], C + T_cur[:, None] * bgc, bgc)
    depth = torch.where(active, D + T_cur, 1.0)
    return (color.float().t().reshape(3, H, W),
            depth.float().reshape(1, H, W), active.reshape(H, W))


def render(verts, faces, vcolor, fopac, mv_t, proj_t, finten, tets,
           face_tets, tet_faces, bg, H: int, W: int,
           max_steps: int = MAX_STEPS, shade=torch.float32, counts=None):
    """Every view of a batch: (color [B, 3, H, W], depth [B, 1, H, W],
    active [B, H, W])."""
    outs = [render_view(verts, faces, vcolor, fopac, mv_t[b:b + 1],
                        proj_t[b:b + 1], finten[b], tets, face_tets,
                        tet_faces, bg, H, W, max_steps, shade, counts)
            for b in range(mv_t.shape[0])]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))
