"""Tile binning: (face, tile) pair emission, tile sort and tile ranges.

A port of the JAX package's ``ops/binning.py``, written the plain GPU way
(the TPU's gather-free boundary scatters and cummax fills are not needed):

1. per-view stable depth pre-sort of the faces (``torch.sort(stable=True)``
   over [B, F]) by mean depth, or by minimum depth for the tet first hit;
2. emission at static sizes. The exact path (tri) expands each emitting
   face into (face, tile-row) runs and each run into its covered tiles; a
   tile row is kept only where the conservative corner test of
   ``_row_tile_interval`` passes, so only pairs that can cover a pixel are
   emitted. The bbox path (the tet first hit, and tri above
   ``_EXACT_KCAP_MAX``) emits every tile of each face's bounding rect:
   slot k of a face's rect is tile (rx + k % nx, ry + k // nx), row-major;
3. one stable sort of the slots by int tile key (CUB radix sort on the
   card), which keeps the emission order -- depth-sorted face, tile row,
   tx -- inside every tile;
4. tile ranges by ``searchsorted``.

Both paths have the JAX package's static shapes: the slot table holds
``kcap`` slots (and the exact path's run table ``run_capacity`` rows)
whatever the scene, each position finds its owner by ``searchsorted`` over
the inclusive prefix sum of the counts (``owners``), and the positions past
the live count take the sentinel tile key ``B * n_tiles``, which sorts them
last and out of every tile's range. No count is read on the host, so both
paths run inside a CUDA graph capture.

The result is the same set and per-tile order of pairs as the JAX package,
under the same capacity policy: at most ``kcap`` slots (and ``run_cap``
runs) are kept in emission order, so the farthest faces of the highest view
lose their tiles first, and ``overflow`` is ``total > kcap`` or a run-table
overflow. The number of emitted pairs (``total``) is exact and independent
of the key capacity, as ``num_rendered`` of the JAX package (runs past the
run table emit no pairs), and the exact path's number of (face, tile-row)
runs (``runs``) is exact and independent of both capacities.

The run table has no ceiling: the JAX package clamps it at 2^21 rows (its
TPU layout's), which eight views of 100,000 faces outgrow (~2.77 M runs).
Every position and offset is int64 and only tile coordinates (below the
grid's size) are cast to float32, so the table is exact at any size that
fits in memory.

Not ported, by design: slab alignment (``align_to_slabs``), which exists
for the TPU's DMA windows; the CUDA kernel reads unaligned [start, end)
ranges.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import torch

from ..utils.config import BIN_TILE, SUBPIXEL
from .geometry import preprocess_faces, project_verts, sat_i32

# The JAX package takes bbox emission above this key capacity; the port
# does the same so both report the same pair count for any capacity.
_EXACT_KCAP_MAX = 1 << 28


class BinnedKeys(NamedTuple):
    """Tile-sorted (face, tile) pairs.

    ``slot_face`` holds indices into the per-view depth-sorted face order
    (view * F + rank); ``sigma`` maps that order back to original
    view * F + face ids. The live slots, min(total, kcap) = ``ends[-1]`` of
    them, come first; the rest hold the sentinel B * F and lie in no tile's
    range."""
    slot_face: torch.Tensor  # [kcap] int32
    sigma: torch.Tensor      # [B*F] int64
    starts: torch.Tensor     # [B * n_tiles] int32
    ends: torch.Tensor       # [B * n_tiles] int32
    total: torch.Tensor      # [] int64 emitted pairs (before the capacity)
    overflow: torch.Tensor   # [] bool
    # [] int64 (face, tile-row) runs (before the run table's capacity); 0 on
    # the bbox path, which has no run table
    runs: torch.Tensor


def _row_tile_interval(ea, eb, ec, rx, nx, tyf, tile_px, grid_x):
    """Conservative covered tile interval [lo, lo + cnt) of one tile row.

    For each edge, s = A px + B py + C must be < 0 at some pixel sample of a
    covered tile; s is affine, so its minimum over the tile is at a corner,
    and per row the passing tx form an interval cut by three half-lines.
    The f32 margins only widen the interval. ea/eb/ec: 3-tuples of f32
    tensors; rx/nx: f32 rect origin/width; tyf: f32 tile row. Returns
    (lo, cnt) as f32. The op order is the JAX package's, so the counts are
    bit-identical."""
    ts = 16.0 * tile_px
    lof = rx
    hif = rx + nx - 1.0
    empty = torch.zeros(tyf.shape, dtype=torch.bool, device=tyf.device)
    for e in range(3):
        a, b, c = ea[e], eb[e], ec[e]
        ox = torch.where(a > 0, 8.0, ts - 16.0 + 8.0)
        oy = torch.where(b > 0, 8.0, ts - 16.0 + 8.0)
        yrow = ts * tyf + oy
        h = a * ox + b * yrow + c
        eps = 512.0 + 1e-6 * (torch.abs(a) * ts + torch.abs(b * yrow)
                              + torch.abs(c))
        g = a * ts
        bound = ((eps - h) / torch.where(g == 0.0, 1.0, g)).clamp(
            -2.0, grid_x + 2.0)
        hif = torch.where(g > 0, torch.minimum(hif, torch.floor(bound + 1e-3)),
                          hif)
        lof = torch.where(g < 0, torch.maximum(lof, torch.ceil(bound - 1e-3)),
                          lof)
        empty = empty | ((g == 0.0) & (h >= eps))
    lof = torch.maximum(lof, rx)
    hif = torch.minimum(hif, rx + nx - 1.0)
    cnt = torch.where(empty, 0.0, torch.clamp(hif - lof + 1.0, min=0.0))
    return lof, cnt


def _edge_wrap_risk(pre: dict, grid_x: int, grid_y: int,
                    tile_px: int) -> torch.Tensor:
    """[B, F] bool: the face's int32 edge functions can wrap somewhere on
    the tile grid (a vertex near the w=0 plane). The interval cull reasons
    about true signs, so such faces emit their full bbox rect instead."""
    s_max = float(SUBPIXEL * tile_px * max(grid_x, grid_y))
    m = torch.zeros(pre["tiles"].shape, dtype=torch.float32,
                    device=pre["tiles"].device)
    for e in range(3):
        m = torch.maximum(
            m,
            (torch.abs(pre["edge_a"][e].float())
             + torch.abs(pre["edge_b"][e].float())) * s_max
            + torch.abs(pre["edge_c"][e].float()))
    return m >= 2.0 ** 30


def exact_tile_counts(pre: dict, grid_x: int, grid_y: int,
                      tile_px: int) -> torch.Tensor:
    """[B, F] int32: the number of rect tiles whose conservative corner test
    passes (wrap-risk faces count their full rect)."""
    eA = [a.float()[None] for a in pre["edge_a"]]
    eB = [b.float()[None] for b in pre["edge_b"]]
    eC = [c.float()[None] for c in pre["edge_c"]]
    rmin, rmax = pre["rect_min"], pre["rect_max"]
    rx = rmin[..., 0].float()[None]
    nx = (rmax[..., 0] - rmin[..., 0]).float()[None]
    ry = rmin[..., 1][None]
    ny = (rmax[..., 1] - rmin[..., 1])[None]
    r = torch.arange(grid_y, dtype=torch.int32,
                     device=rx.device)[:, None, None]
    tyf = (ry + r).float()
    _lo, cnt = _row_tile_interval(eA, eB, eC, rx, nx, tyf, tile_px, grid_x)
    risk = _edge_wrap_risk(pre, grid_x, grid_y, tile_px)
    cnt = torch.where(risk[None], nx, cnt)
    cnt = torch.where(r < ny, cnt, 0.0)
    total = sat_i32(cnt.sum(dim=0))
    return torch.where((pre["tiles"] > 0) & pre["nondeg"], total,
                       torch.zeros_like(total))


def _depth_presort(pre: dict, emit_counts: torch.Tensor,
                   sort_by: str = "depth") -> torch.Tensor:
    """Per-view stable face order by depth key (``pre[sort_by]``); faces
    that emit nothing go last. Returns sigma [B*F]: the original view*F+face
    id of each rank."""
    B, F = emit_counts.shape
    key = torch.where(emit_counts > 0, pre[sort_by], math.inf)
    sigma_v = torch.sort(key, dim=1, stable=True).indices
    offs = torch.arange(B, device=key.device)[:, None] * F
    return (sigma_v + offs).reshape(-1)


def owners(counts: torch.Tensor, n: int):
    """The owner of each of ``n`` positions when item i owns ``counts[i]``
    consecutive ones, at a static size with no host read: ``searchsorted``
    over the inclusive prefix sum of ``counts``. Returns (owner [n],
    clamped to the last item past the counts' total; live [n], the
    positions below the total; the exclusive prefix sum of ``counts``;
    their total, a 0-d tensor)."""
    incl = torch.cumsum(counts, 0)
    pos = torch.arange(n, dtype=incl.dtype, device=counts.device)
    owner = torch.searchsorted(incl, pos, right=True)
    live = owner < counts.numel()
    return owner.clamp_(max=counts.numel() - 1), live, incl - counts, incl[-1]


def run_capacity(bf: int, kcap: int, run_cap: int | None = None) -> int:
    """Capacity of the (face, tile-row) run table: ``run_cap`` when given
    (measured rows + margin, ``recommended_run_capacity``), else the JAX
    package's shape heuristic max(4 B F, kcap / 4), at least 1024; rounded
    up to a multiple of 128. Unlike the JAX package's, it has no ceiling
    (module docstring)."""
    cap = max(4 * bf, kcap // 4) if run_cap is None else int(run_cap)
    return ((max(1024, cap) + 127) // 128) * 128


def default_key_capacity(B: int, F: int, avg_tiles_per_face: int = 16) -> int:
    """Key capacity heuristic, rounded to a multiple of 128."""
    kcap = max(1024, B * F * avg_tiles_per_face)
    return ((kcap + 127) // 128) * 128


def overflow_warning(total: int, kcap: int, context: str,
                     runs: int | None = None, run_cap: int = 0,
                     settings: str | None = None) -> None:
    """Warn that the binning dropped work, naming the table that overflowed
    and the setting to raise: the key slots, where ``total`` (face, tile)
    pairs were emitted for ``kcap`` slots (the JAX package's wording,
    ``binning.overflow_warning``), and the run table, where ``runs`` (face,
    tile-row) runs were emitted for ``run_cap`` rows (``runs`` None: the
    render has no run table). ``settings``: the render settings class
    whose ``key_capacity``/``run_capacity`` the context names. The renders
    also report the overflow as data (``return_aux``,
    ``tri_render_stats``)."""
    parts, fields = [], []
    if total > kcap:
        fields.append("key_capacity")
        parts.append(
            f"tile-binning key capacity overflow ({total} (face, tile) pairs "
            f"emitted > capacity {kcap}). The FARTHEST faces of the highest "
            "view drop their tiles first. Raise the key capacity.")
    if runs is not None and runs > run_cap:
        fields.append("run_capacity")
        parts.append(
            f"tile-binning run table overflow ({runs} (face, tile-row) runs "
            f"emitted > capacity {run_cap} rows). The FARTHEST faces of the "
            "highest view drop their tile rows first. Raise the run "
            "capacity.")
    if settings is not None:
        context += "; raise " + " and ".join(f"{settings}.{f}"
                                             for f in fields)
    warnings.warn(f"dmesh_renderer_tpu_torch ({context}): " + " ".join(parts),
                  stacklevel=4)


def is_capturing(device: torch.device) -> bool:
    """Whether ``device``'s current stream is capturing a CUDA graph (never
    on the CPU)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def warn_if_overflow(overflow: torch.Tensor, total: torch.Tensor, kcap: int,
                     context: str, extra=(), runs: torch.Tensor | None = None,
                     run_cap: int = 0, settings: str | None = None):
    """Read ``overflow``, ``total``, ``runs`` (where given) and the 0-d
    integer tensors ``extra`` in one transfer (the frame's one host read,
    ``host_read``), warn (``overflow_warning``, with ``run_cap`` and
    ``settings``) if the flag is set, and return the values of ``extra`` as
    ints. While the stream captures a CUDA graph nothing is read and None
    is returned: the flag stays data, as the JAX package leaves it on a
    backend without host callbacks."""
    if is_capturing(overflow.device):
        return None
    counts = () if runs is None else (runs,)
    flag, n, *rest = host_read(overflow, total, *counts, *extra)
    if flag:
        overflow_warning(n, kcap, context, rest[0] if counts else None,
                         run_cap, settings)
    return rest[len(counts):]


def host_read(*values: torch.Tensor) -> list:
    """The 0-d tensors ``values`` as ints, in one device-to-host transfer."""
    return torch.stack([v.to(torch.int64) for v in values]).tolist()


def emit_and_sort(pre: dict, grid_x: int, grid_y: int, kcap: int,
                  tile_px: int | None = None,
                  run_cap: int | None = None,
                  sort_by: str = "depth") -> BinnedKeys:
    """Build the tile-sorted pair table from ``preprocess_faces`` output, at
    static sizes with no host read (module docstring).

    With ``tile_px`` (the tri render path), exact-coverage emission; without
    it (the tet first hit), or above the exact path's capacity limit, every
    tile of the bbox rect is emitted, as in the JAX package. ``sort_by``:
    the per-face depth key that orders each tile's list, "depth" (mean
    depth, tri) or "min_depth" (tet). The overflow is data
    (``warn_if_overflow`` reads it)."""
    if sort_by not in ("depth", "min_depth"):
        raise ValueError(f"sort_by must be 'depth' or 'min_depth', got "
                         f"{sort_by!r}")
    tiles = pre["tiles"]
    B, F = tiles.shape
    dev = tiles.device
    if not (tile_px is not None and kcap < _EXACT_KCAP_MAX and tiles.numel()):
        return _emit_bbox(pre, grid_x, grid_y, kcap, sort_by)
    n_tiles = grid_x * grid_y
    rmin, rmax = pre["rect_min"], pre["rect_max"]
    counts = exact_tile_counts(pre, grid_x, grid_y, tile_px)
    sigma = _depth_presort(pre, counts, sort_by)
    take = lambda x: x.reshape(B * F, *x.shape[2:])[sigma]

    # --- (face, tile-row) runs, in emission order, at the run capacity ---
    ny_s = take(rmax[..., 1] - rmin[..., 1]).long()
    ny_eff = torch.where(take(counts) > 0, ny_s, 0)
    nr_cap = run_capacity(B * F, kcap, run_cap)
    runq, run_live, row_excl, n_rows = owners(ny_eff, nr_cap)
    ridx = torch.arange(nr_cap, device=dev) - row_excl[runq]
    rx = take(rmin[..., 0])[runq].float()
    nx = take(rmax[..., 0] - rmin[..., 0])[runq].float()
    cols = [take(pre[k][e])[runq].float()
            for k in ("edge_a", "edge_b", "edge_c") for e in range(3)]
    tyf = take(rmin[..., 1])[runq].float() + ridx.float()
    lo_f, cnt_f = _row_tile_interval(cols[0:3], cols[3:6], cols[6:9], rx, nx,
                                     tyf, tile_px, grid_x)
    risk = take(_edge_wrap_risk(pre, grid_x, grid_y, tile_px))[runq]
    lo_f = torch.where(risk, rx, lo_f)
    cnt_f = torch.where(risk, nx, cnt_f)
    rcnt = torch.where(run_live, sat_i32(cnt_f).long(), 0)
    rlo = sat_i32(lo_f.clamp(0.0, grid_x - 1.0)).long()
    rty = sat_i32(tyf.clamp(0.0, grid_y - 1.0)).long()

    # --- runs -> slots (the first kcap in emission order are kept) ---
    run, live, excl, total = owners(rcnt, kcap)
    k = torch.arange(kcap, device=dev) - excl[run]
    bf = runq[run]
    tile_key = (bf // F) * n_tiles + rty[run] * grid_x + rlo[run] + k
    tile_key = torch.where(live, tile_key, B * n_tiles)
    bf = torch.where(live, bf, B * F)
    overflow = (total > kcap) | (n_rows > nr_cap)
    return _sort_and_ranges(tile_key, bf, sigma, B * n_tiles, total,
                            overflow, n_rows)


def _emit_bbox(pre, grid_x, grid_y, kcap, sort_by):
    """Bbox emission at ``kcap`` slots, the JAX package's bbox path: each
    slot's owner face in the depth-presorted order and the face's first
    slot (``owners``); slot k of a face's rect is tile (rx + k % nx,
    ry + k // nx), nx clamped at 1 as JAX packs it. The same row-major
    order within each rect as one run per tile row, so the live slots are
    those of a host-sized emission, bit for bit."""
    tiles = pre["tiles"]
    B, F = tiles.shape
    dev = tiles.device
    n_tiles = grid_x * grid_y
    dead_key = torch.full((kcap,), B * n_tiles, dtype=torch.int64,
                          device=dev)
    if B * F == 0:
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return _sort_and_ranges(dead_key, torch.zeros_like(dead_key),
                                torch.zeros(0, dtype=torch.int64, device=dev),
                                B * n_tiles, zero, zero > 0, zero)
    rmin, rmax = pre["rect_min"], pre["rect_max"]
    sigma = _depth_presort(pre, tiles, sort_by)
    take = lambda x: x.reshape(B * F)[sigma]
    face, live, excl, total = owners(take(tiles).long(), kcap)
    k = torch.arange(kcap, device=dev) - excl[face]
    nx = take(rmax[..., 0] - rmin[..., 0]).clamp(min=1).long()[face]
    tx = take(rmin[..., 0]).long()[face] + k % nx
    ty = take(rmin[..., 1]).long()[face] + k // nx
    tile_key = torch.where(live, (face // F) * n_tiles + ty * grid_x + tx,
                           dead_key)
    bf = torch.where(live, face, B * F)
    # no run table: runs is 0, the exclusive sum's first entry (a view, so
    # no kernel joins a captured step)
    return _sort_and_ranges(tile_key, bf, sigma, B * n_tiles, total,
                            total > kcap, excl[0])


def _sort_and_ranges(tile_key, bf, sigma, n_tiles_total, total, overflow,
                     runs):
    """Stable sort of the slots by tile key (keeps the emission order inside
    every tile; int32 keys where they fit, half the radix passes of int64)
    and each tile's [start, end) range."""
    if n_tiles_total < 2 ** 31:
        tile_key = tile_key.to(torch.int32)
    tile_key_s, perm = torch.sort(tile_key, stable=True)
    tids = torch.arange(n_tiles_total, dtype=tile_key.dtype,
                        device=tile_key.device)
    starts = torch.searchsorted(tile_key_s, tids, right=False)
    ends = torch.searchsorted(tile_key_s, tids, right=True)
    return BinnedKeys(
        slot_face=bf[perm].to(torch.int32),
        sigma=sigma,
        starts=starts.to(torch.int32),
        ends=ends.to(torch.int32),
        total=total,
        overflow=overflow,
        runs=runs,
    )


def _scene_pre(verts, faces, mv_t, proj_t, height, width, tile_px):
    gx = (width + tile_px - 1) // tile_px
    gy = (height + tile_px - 1) // tile_px
    ndc, img = project_verts(verts, mv_t, proj_t, width, height)
    return preprocess_faces(ndc, img, faces, width, height, tile_px,
                            tile_px), gx, gy


def recommended_key_capacity(verts, faces, mv_t, proj_t, height, width, *,
                             tile_px: int | None = None,
                             margin: float = 1.25, exact: bool = True,
                             bucket: int = 65_536) -> int:
    """Measure a scene's (face, tile) pair count and return a key capacity
    with ``margin`` headroom, rounded up to a multiple of ``bucket``
    (``exact=False`` counts bbox rects). Tensors in, on any device."""
    tile_px = BIN_TILE if tile_px is None else tile_px
    pre, gx, gy = _scene_pre(verts, faces, mv_t, proj_t, height, width,
                             tile_px)
    if exact:
        total = int(exact_tile_counts(pre, gx, gy, tile_px).sum())
    else:
        total = int(torch.where(pre["valid"], pre["tiles"], 0).sum())
    need = max(1024, int(math.ceil(total * margin)))
    return ((need + bucket - 1) // bucket) * bucket


def recommended_run_capacity(verts, faces, mv_t, proj_t, height, width, *,
                             tile_px: int | None = None,
                             margin: float = 1.25,
                             bucket: int = 8192) -> int:
    """Measure a scene's (face, tile-row) run count and return a run-table
    capacity with ``margin`` headroom, rounded up to ``bucket``."""
    tile_px = BIN_TILE if tile_px is None else tile_px
    pre, gx, gy = _scene_pre(verts, faces, mv_t, proj_t, height, width,
                             tile_px)
    cnt = exact_tile_counts(pre, gx, gy, tile_px)
    ny = torch.where(cnt > 0, pre["rect_max"][..., 1] - pre["rect_min"][..., 1],
                     0)
    need = max(1024, int(math.ceil(int(ny.sum()) * margin)))
    return ((need + bucket - 1) // bucket) * bucket
