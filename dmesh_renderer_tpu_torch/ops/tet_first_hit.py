"""Tile-binned first hit of the tet renderer (kernel K3).

A port of the JAX package's ``ops/tet_first_hit.py``. Every (face, tile)
pair of each face's bounding rect at 32-px tiles is emitted, and each tile's
list is sorted by per-face minimum depth (``binning.emit_and_sort`` with
``sort_by="min_depth"``). Per pixel, ``first_hit`` walks its tile's list
and keeps the strict Moller-Trumbore hit with the smallest ray parameter t
(the first face in list order wins a tie), stopping once it has a hit and
the next face's minimum depth exceeds the hit face's maximum depth.

The kernel reads a compact per-(view, face) table, [B*F, 16] f32 in the
per-view depth-sorted row order of ``BinnedKeys.slot_face``: T = o - p0,
E1, E2, Q = T x E1, min depth, max depth and the face id (an exact float,
ids < 2^24), one pad column. Not ported, by design: the slab-aligned
slot-scale attribute table of the TPU kernel.
"""

from __future__ import annotations


import torch

from ..kernels import launch
from ..utils.config import BIN_TILE
from .binning import emit_and_sort, warn_if_overflow
from .geometry import cross

TILE = BIN_TILE  # side of the pixel tile one kernel block covers
ROUND = 32  # slots a block stages per round
FH_COLS = 16
_TV, _E1, _E2, _QV, _MIND, _MAXD, _FID = 0, 3, 6, 9, 12, 13, 14
_BIG = 3.0e38


def build_first_hit_table(verts, faces, cam_o, min_depth, max_depth):
    """[B*F, 16] f32 first-hit rows in original view * F + face order.
    cam_o [B, 3] (the rays' origin); min_depth/max_depth [B, F]."""
    B = cam_o.shape[0]
    F = faces.shape[0]
    gv = verts[faces.long()]  # [F, 3, 3]
    p0 = gv[:, 0]
    e1 = gv[:, 1] - p0
    e2 = gv[:, 2] - p0
    tv = cam_o[:, None, :] - p0[None]  # [B, F, 3]
    qv = cross(tv, e1[None].expand(tv.shape))
    fid = torch.arange(F, dtype=torch.float32, device=verts.device)
    tab = torch.cat([
        tv, e1[None].expand(B, F, 3), e2[None].expand(B, F, 3), qv,
        min_depth[..., None], max_depth[..., None],
        fid[None, :, None].expand(B, F, 1),
        torch.zeros((B, F, 1), dtype=torch.float32, device=verts.device),
    ], dim=-1)
    return tab.reshape(B * F, FH_COLS).contiguous()


def _check_args(starts, ends, slot_face, table, ray_d, B, H, W):
    n_tiles = B * ((H + TILE - 1) // TILE) * ((W + TILE - 1) // TILE)
    want = ((starts, torch.int32, (n_tiles,)), (ends, torch.int32, (n_tiles,)),
            (slot_face, torch.int32, None),
            (table, torch.float32, (table.shape[0], FH_COLS)),
            (ray_d, torch.float32, (B, H, W, 3)))
    if slot_face.ndim != 1:
        raise ValueError("first_hit: slot_face must be 1-D")
    for t, dtype, shape in want:
        if t.dtype != dtype:
            raise TypeError(f"first_hit: expected {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"first_hit: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != ray_d.device:
            raise ValueError("first_hit: all tensors must share a device")


def first_hit(starts, ends, slot_face, table, ray_d, B: int, H: int, W: int):
    """The first strict hit of every pixel's ray in its tile's list (K3).

    starts/ends [B*gy*gx] int32 tile ranges into ``slot_face`` [S] int32
    (rows of the depth-sorted first-hit table [B*F, 16]); ray_d [B, H, W, 3].
    Returns (first_face [B, H, W] int32 (-1: no hit), t (0 on a miss), u, v
    [B, H, W] f32, walked [B, gy, gx] int32): ``walked`` is the number of
    slots each tile's block staged, in rounds of ``ROUND`` with the next
    round staged while one is walked, until at a round's start all of the
    tile's pixels were done: min(list length, ROUND x (rounds walked + 1)).

    On CUDA tensors this launches the kernel of csrc/tet_fwd.cu (and raises
    if it cannot); on CPU tensors it runs ``first_hit_plain``."""
    _check_args(starts, ends, slot_face, table, ray_d, B, H, W)
    if ray_d.device.type == "cpu":
        return first_hit_plain(starts, ends, slot_face, table, ray_d, B, H, W)
    if ray_d.device.type != "cuda":
        raise ValueError(f"first_hit: unsupported device {ray_d.device}")
    tensors = [x.contiguous() for x in (starts, ends, slot_face, table,
                                        ray_d)]
    if tensors[3].data_ptr() % 16:
        tensors[3] = tensors[3].clone()  # the kernel reads rows as float4
    dev = ray_d.device
    gy, gx = (H + TILE - 1) // TILE, (W + TILE - 1) // TILE
    tuv = torch.empty((B, 3, H, W), dtype=torch.float32, device=dev)
    face = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    walked = torch.empty((B, gy, gx), dtype=torch.int32, device=dev)
    launch("tet_fwd", "tet_first_hit", tensors + [tuv, face, walked],
           [B, H, W], dev)
    first_hit.launches += 1
    return face, tuv[:, 0], tuv[:, 1], tuv[:, 2], walked


first_hit.launches = 0


def first_hit_plain(starts, ends, slot_face, table, ray_d, B: int, H: int,
                    W: int, with_visits: bool = False):
    """Plain torch version of ``first_hit``: the same inputs, outputs and
    per-pixel arithmetic, vectorised over the pixels and sequential over
    the list position. Each step walks the pixels that are not done and
    whose list is longer; ``walked`` follows from the position at which
    each pixel became done and the kernel's rounds.

    ``with_visits``: also return the number of faces each pixel
    hit-tested [B, H, W] int64 (the work its result needs)."""
    dev = ray_d.device
    gx = (W + TILE - 1) // TILE
    gy = (H + TILE - 1) // TILE
    N = B * H * W
    bi = torch.arange(B, device=dev)[:, None, None]
    yi = torch.arange(H, device=dev)[None, :, None]
    xi = torch.arange(W, device=dev)[None, None, :]
    tile = ((bi * gy + yi // TILE) * gx + xi // TILE).reshape(N)
    start = starts.long()[tile]
    count = (ends - starts).long()[tile]
    d = ray_d.reshape(N, 3)

    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    bt = big.expand(N).clone()
    bmax = torch.zeros(N, dtype=torch.float32, device=dev)
    bu = torch.zeros(N, dtype=torch.float32, device=dev)
    bv = torch.zeros(N, dtype=torch.float32, device=dev)
    bface = torch.full((N,), -1, dtype=torch.int32, device=dev)
    never = 1 << 40
    done_at = torch.full((N,), never, dtype=torch.int64, device=dev)
    live = torch.arange(N, device=dev)
    k = 0
    while True:
        live = live[count[live] > k]
        if live.numel() == 0:
            break
        f = table[slot_face[start[live] + k].long()]
        btl = bt[live]
        stop = (btl < big) & (f[:, _MIND] > bmax[live])
        done_at[live[stop]] = k
        live, f, btl = live[~stop], f[~stop], btl[~stop]
        dx, dy, dz = d[live, 0], d[live, 1], d[live, 2]
        e1x, e1y, e1z = f[:, _E1], f[:, _E1 + 1], f[:, _E1 + 2]
        e2x, e2y, e2z = f[:, _E2], f[:, _E2 + 1], f[:, _E2 + 2]
        qvx, qvy, qvz = f[:, _QV], f[:, _QV + 1], f[:, _QV + 2]
        Px = dy * e2z - dz * e2y
        Py = dz * e2x - dx * e2z
        Pz = dx * e2y - dy * e2x
        denom = Px * e1x + Py * e1y + Pz * e1z
        nd = denom != 0.0
        inv = torch.reciprocal(torch.where(nd, denom, 1.0))
        tt = (qvx * e2x + qvy * e2y + qvz * e2z) * inv
        u = (Px * f[:, _TV] + Py * f[:, _TV + 1] + Pz * f[:, _TV + 2]) * inv
        v = (qvx * dx + qvy * dy + qvz * dz) * inv
        hit = nd & (tt >= 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        better = hit & (tt < btl)
        upd = live[better]
        bt[upd] = tt[better]
        bmax[upd] = f[better, _MAXD]
        bface[upd] = f[better, _FID].to(torch.int32)
        bu[upd] = u[better]
        bv[upd] = v[better]
        k += 1

    # walked: a tile's block walks rounds until, at a round's start, every
    # one of its pixels is done (a pixel is done in the round that holds the
    # slot that stopped it), and stages each round while it walks the one
    # before
    last = torch.full((B * gy * gx,), -1, dtype=torch.int64, device=dev)
    last = last.scatter_reduce(0, tile, done_at, "amax")
    tcount = (ends - starts).long()
    walked_rounds = torch.clamp(last, max=never - 1) // ROUND + 1
    staged = torch.minimum((tcount + ROUND - 1) // ROUND, walked_rounds + 1)
    walked = torch.minimum(tcount, staged * ROUND).to(torch.int32)

    shape = (B, H, W)
    t = torch.where(bt < big, bt, 0.0)
    out = (bface.reshape(shape), t.reshape(shape), bu.reshape(shape),
           bv.reshape(shape), walked.reshape(B, gy, gx))
    if with_visits:
        visits = torch.where(done_at == never, count, done_at)
        return out + (visits.reshape(shape),)
    return out


def first_intersection_binned(verts, faces, pre, cam_o, ray_d, height: int,
                              width: int, B: int, kcap: int):
    """The binned first hit. ``pre``: ``preprocess_faces`` at 32-px tiles;
    cam_o [B, 3]; ray_d [B, H, W, 3] (jitter included).

    Returns (first_face [B, N] int32 (-1: no hit), t, u, v [B, N] f32,
    (overflow bool[], num_rendered int64[], walked int64[])): whether the
    key capacity dropped (face, tile) pairs (a dropped pair makes that face
    unhittable in that tile), how many pairs the faces emitted, and how many
    list slots the kernel staged."""
    gx = (width + TILE - 1) // TILE
    gy = (height + TILE - 1) // TILE
    keys = emit_and_sort(pre, gx, gy, kcap, sort_by="min_depth")
    table = build_first_hit_table(verts, faces, cam_o, pre["min_depth"],
                                  pre["max_depth"])[keys.sigma]
    face, t, u, v, walked = first_hit(keys.starts, keys.ends, keys.slot_face,
                                      table, ray_d, B, height, width)
    warn_if_overflow(keys.overflow, keys.total, kcap,
                     "tet first hit; a dropped face cannot be hit")
    N = height * width
    return (face.reshape(B, N), t.reshape(B, N), u.reshape(B, N),
            v.reshape(B, N),
            (keys.overflow, keys.total, walked.long().sum()))
