"""Deterministic segment sum: rows of a [N, C] f32 tensor into segments.

The backward's per-face record reduce and per-vertex scatter, of the tri
and the tet renderer alike, go through this module. torch's CUDA ``index_add_``, ``scatter_add_`` and
``index_put_(accumulate=True)`` on floats use atomics, so their sums change
from run to run; the renderer's gradients are bitwise deterministic, so
they cannot use them.

A ``SegmentCSR`` (built once per segment-id vector with a stable sort, a
``bincount`` and a ``cumsum``) lists each segment's rows in their original
order. ``seg_sum`` then adds each segment's rows sequentially in that order,
starting from 0: on CUDA tensors the ``seg_sum`` kernel of csrc/tri_bwd.cu
(a warp per group of segments, its lanes over the columns and, for narrow
rows and long segments, over several rows, each lane with 4 or 8 rows in
flight), on CPU tensors ``seg_sum_plain``, which does the same f32
additions in the same order, so the two agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SegmentCSR(NamedTuple):
    """Rows grouped by segment: segment s holds rows
    ``order[offsets[s]:offsets[s + 1]]``, in increasing row order."""
    order: torch.Tensor    # [N] int32 row ids
    offsets: torch.Tensor  # [n_segments + 1] int64


def segment_csr(seg_ids: torch.Tensor, n_segments: int,
                inner: int = 1) -> SegmentCSR:
    """CSR of the rows of a [len(seg_ids) * inner, C] tensor whose row r
    belongs to segment ``seg_ids[r // inner]`` (ids in [0, n_segments)).

    ``inner`` > 1 groups ``inner`` consecutive rows under one id without
    sorting ``inner`` times as many keys; the order is the one a stable
    sort of the expanded ids would give."""
    ids = seg_ids.reshape(-1).long()
    if ids.numel() * inner >= 2 ** 31:
        raise ValueError(f"segment_csr: {ids.numel() * inner} rows do not "
                         "fit int32 row ids")
    order = torch.sort(ids, stable=True).indices.to(torch.int32)
    counts = torch.bincount(ids, minlength=n_segments) * inner
    offsets = torch.zeros(n_segments + 1, dtype=torch.int64,
                          device=ids.device)
    offsets[1:] = torch.cumsum(counts, 0)
    if inner > 1:
        order = (order[:, None] * inner + torch.arange(
            inner, dtype=torch.int32, device=ids.device)).reshape(-1)
    return SegmentCSR(order, offsets)


def _check(values: torch.Tensor, csr: SegmentCSR):
    if values.dtype != torch.float32 or values.ndim != 2:
        raise TypeError(
            f"seg_sum: values must be a 2-D float32 tensor, got "
            f"{values.dtype} {tuple(values.shape)}")
    if csr.order.dtype != torch.int32 or csr.offsets.dtype != torch.int64:
        raise TypeError("seg_sum: order must be int32 and offsets int64")
    if csr.order.numel() != values.shape[0]:
        raise ValueError(
            f"seg_sum: {csr.order.numel()} ordered rows for "
            f"{values.shape[0]} value rows")
    if csr.order.device != values.device or \
            csr.offsets.device != values.device:
        raise ValueError("seg_sum: all tensors must share a device")


def seg_sum(values: torch.Tensor, csr: SegmentCSR) -> torch.Tensor:
    """[N, C] f32 -> [n_segments, C] f32, each segment's rows added in
    order from 0. Launches the kernel on CUDA tensors (and raises if it
    cannot); runs ``seg_sum_plain`` on CPU tensors."""
    _check(values, csr)
    if values.device.type == "cpu":
        return seg_sum_plain(values, csr)
    if values.device.type != "cuda":
        raise ValueError(f"seg_sum: unsupported device {values.device}")
    from ..kernels import launch

    n_seg = csr.offsets.numel() - 1
    N, C = values.shape
    vals = values.contiguous()
    if C % 2 == 0 and C <= 16 and vals.data_ptr() % 8:
        vals = vals.clone()  # narrow even rows are read as float2
    order = csr.order.contiguous()
    offsets = csr.offsets.contiguous()
    out = torch.empty((n_seg, C), dtype=torch.float32, device=values.device)
    launch("tri_bwd", "seg_sum", [vals, order, offsets, out], [n_seg, C, N],
           values.device)
    seg_sum.launches += 1
    return out


seg_sum.launches = 0


def corner_sum(faces, n_verts: int, rows):
    """Per-corner rows -> per-vertex sums, one segment sum: ``rows``
    [F * 3, C] holds one row per face corner (corner c of face f at row
    3 f + c); returns [P, C]."""
    return seg_sum(rows, segment_csr(faces, n_verts))


def faces_to_verts(faces, n_verts: int, g_p, g_vc, g_vd):
    """Per-face corner gradients -> per-vertex gradients, one segment sum.

    faces [F, 3]; g_p, g_vc [F, 3 corners, 3] (positions, colours); g_vd
    [B, F, 3] (per-view vertex depths). Returns (g_verts [P, 3], g_vcolor
    [P, 3], g_vdepth [B, P])."""
    acc = corner_sum(faces, n_verts, corner_rows(g_p, g_vc, g_vd))
    return acc[:, 0:3], acc[:, 3:6], acc[:, 6:].t().contiguous()


def corner_rows(g_p, g_vc, g_vd):
    """``faces_to_verts``' segment-sum input: one [6 + B] row per face
    corner (position, colour, the B per-view depths), [F * 3, 6 + B]."""
    F, B = g_p.shape[0], g_vd.shape[0]
    upd = torch.cat([g_p, g_vc, g_vd.permute(1, 2, 0)], dim=-1)
    return upd.reshape(F * 3, 6 + B).contiguous()


def seg_sum_plain(values: torch.Tensor, csr: SegmentCSR) -> torch.Tensor:
    """Plain torch version of ``seg_sum``: the same additions in the same
    order, vectorised over segments and sequential over the position k in
    the segment."""
    n_seg = csr.offsets.numel() - 1
    out = torch.zeros((n_seg, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    counts = csr.offsets[1:] - csr.offsets[:-1]
    live = torch.arange(n_seg, device=values.device)
    k = 0
    while True:
        live = live[counts[live] > k]
        if live.numel() == 0:
            return out
        out[live] = out[live] + values[csr.order[csr.offsets[live] + k]]
        k += 1
