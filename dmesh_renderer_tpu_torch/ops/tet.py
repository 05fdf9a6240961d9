"""Tet renderer: the first hit, the march through the tets, and its
backward.

A port of the JAX package's ``ops/tet.py``. The renderer composites the
faces of a tetrahedral tessellation with exact depth order by walking each
pixel's ray through the tet connectivity:

  project_verts + preprocess_faces
  -> generate_rays (tet norm mode, optional threefry jitter)
  -> the first hit: ``first_intersection_dense`` (F at or below the
     device's ``BINNED_FIRST_HIT_THRESHOLD``/``_GPU``) or the binned
     ``tet_first_hit.first_intersection_binned`` (kernel K3)
  -> ``march_tables`` and each ray's start tet, projective z/w and first
     hit t/u/v (``ray_start``), on the card by the two kernels of
     csrc/tet_tables.cu
  -> ``fwd_march`` (kernel K4, csrc/tet_fwd.cu): per ray, blend the current
     face, update log-transmittance, and walk to the next face until T is
     exhausted, the ray leaves the mesh, or the walk breaks
  -> the colour/depth/active assembly.

The ``active`` mask is true only where the march ended validly (T
exhausted or the ray left the mesh); rays that miss the mesh or whose walk
breaks render the background with depth 1.

The backward (``_RenderTet``) gives the reference's gradient surface:
``verts_color`` and ``faces_opacity``; every other float input gets zeros.
It re-walks every active ray from its last face back to its first:

  ``bwd_start_state`` (the last face's t/u/v, the tet before it, the
  upstream gradients and the transmittances, each ray's record slots)
  -> ``bwd_march`` (kernel K5, csrc/tet_bwd.cu): per visited face, the
     rebuilt transmittance, the suffix accumulators, dL/dalpha with the
     background term and the nine colour moments, one record per face
  -> ``reduce_tet_records``: the records summed per face, then per vertex,
     through ``ops/reduce.py`` (``seg_sum``, no atomics).

Every tensor of a frame has a static shape, as in the JAX package, so a
frame and a train step run inside a CUDA graph capture: the first hit's
pairs sit at ``kcap`` slots (``binning.emit_and_sort``), and K5's records at
the capacity ``record_capacity`` = B * H * W * min(``LOG_CAP``, max_steps),
the JAX package's static bound for the backward's memory. A ray whose
record slots pass the capacity gets none, and ``render_tet_backward``
flags it (``render_tet_backward.overflow``). The backward never drops a
record, as JAX's ``lax.cond`` to its marching backward never does: an
eager frame reads the first hit's overflow flag and pair count and the
record total in one transfer after the march (``binning.warn_if_overflow``,
the frame's one host read), and where the total passes the capacity its
backward runs at the total's size. Under a capture nothing is read, and
the flag stays on the device: ``models.dmesh``'s tet step reads it between
its two graphs and redoes a flagged step eagerly. A caller who captures a
tet backward elsewhere must read ``render_tet_backward.overflow`` after
each replay in the same way: a set flag means that replay's gradients
miss records.

Not ported, by design: the phased lockstep march with its compaction, the
per-view mega-table split, the entry-slot mega table with its mirror slots
and gather index, and the (G, NS, 128) row packing. They exist to make the
TPU's per-step row gathers cheap; a CUDA thread that finishes simply
retires. Nor the log-replay backward (the forward's 10-row march log, the
one-hot run extraction on the MXU and its ``REPLAY_*`` budgets), an XLA
device that spares the TPU the per-step gathers of a re-walk: K4 writes no
log, and one re-walk covers every walk depth, as the CUDA original does.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.autograd.function import once_differentiable

from ..kernels import launch
from ..utils import spans
from ..utils.config import BIN_TILE, DEFAULT_MAX_MARCH_STEPS, T_EPS, TILE_X
from .binning import default_key_capacity, warn_if_overflow
from .geometry import (
    clamp_w,
    cross,
    preprocess_faces,
    project_verts,
    ray_tri_intersection,
    sqrt_rn,
    strict_hit,
)
from .rays import generate_rays
from .reduce import corner_sum, seg_sum, segment_csr

# Faces per step of the dense first hit; rays per block of it (bounds the
# [B, rays, faces] temporaries).
FIRST_HIT_CHUNK = 128
FIRST_HIT_RAY_BLOCK = 32768
# Above these face counts the binned first hit (K3) is used: on the CPU
# the JAX package's value, which the parity tests use; on the card its own.
# There the dense first hit was slower than the binned one in fwd+bwd at
# 256x256 on every grid of chip_smoke.py's ladder, from 120 faces up
# (NVIDIA H100), so every scene with a face takes K3.
BINNED_FIRST_HIT_THRESHOLD = 2048
BINNED_FIRST_HIT_THRESHOLD_GPU = 0


@contextlib.contextmanager
def first_hit_path(path):
    """Force the dense (``"dense"``) or the binned (``"binned"``) first hit
    on every device for the duration (both thresholds above)."""
    names = ("BINNED_FIRST_HIT_THRESHOLD", "BINNED_FIRST_HIT_THRESHOLD_GPU")
    saved = [globals()[n] for n in names]
    value = 0 if path == "binned" else 1 << 62
    try:
        globals().update(dict.fromkeys(names, value))
        yield
    finally:
        globals().update(zip(names, saved))


# the context of the first hit's key capacity overflow warning
FH_OVERFLOW_CONTEXT = "tet first hit; a dropped face cannot be hit"

# log(T) after a face of opacity 1: log(T_EPS * 0.1), rounded to f32.
LOG_T_FLOOR = float(torch.tensor(math.log(T_EPS * 0.1), dtype=torch.float32))
TET_GEO_COLS = 40  # p0, e1, e2 of the 4 face slots (36), 4 outward signs
TET_NRM_COLS = 12  # the 4 face slots' outward unit normals (K4's, K5's walk)
TET_ID_COLS = 8    # 4 face ids, 4 neighbour tet ids (-1: none)
GEO_COLS = 12      # a face's p0, e1, e2 and unit normal n-hat
SHADE_COLS = 12    # 9 corner colours, alpha, log(max(1 - alpha, 1e-37)), inten

REC_COLS = 10  # K5 record values: 9 colour moments (vertex-major), dL/dalpha
# K5's records per ray in the static record capacity: the JAX package's
# LOG_CAP, the depth of its march log and the static bound of its backward's
# memory ("Memory: LOG_CAP * M * _NLOG * 4 bytes").
LOG_CAP = 24
# rows of the backward march's per-ray inputs (``bwd_start_state``)
RAY_I_ROWS = 4   # start face, start tet, first face, record count
RAY_F_ROWS = 11  # t, u, v, log T before the start face, dL/dC rgb, dL/dD,
#                  bg . dL/dC + dL/dD, final T, final prev T


# =============================================================================
# First hit (dense)
# =============================================================================

def first_intersection_dense(verts, faces, valid, order, ray_o, ray_d):
    """The first strict hit of every ray over all valid faces.

    verts [P, 3]; faces [F, 3]; valid [B, F]; order [B, F] (faces sorted by
    min depth); ray_o/ray_d [B, N, 3]. The hit with the smallest t wins; of
    equal t, the first in ``order``. Returns (first_face [B, N] int32 (-1:
    no hit), t (0 on a miss), u, v [B, N] f32)."""
    B, F = order.shape
    N = ray_o.shape[1]
    dev = verts.device
    valid_s = torch.take_along_dim(valid, order, dim=1)
    p = verts[faces.long()[order]]  # [B, F, 3, 3]
    inf = torch.full((), math.inf, device=dev)

    best = [torch.full((B, N), math.inf, device=dev),
            torch.full((B, N), -1, dtype=torch.int64, device=dev),
            torch.zeros((B, N), device=dev), torch.zeros((B, N), device=dev)]
    for n0 in range(0, N, FIRST_HIT_RAY_BLOCK):
        rs = slice(n0, min(N, n0 + FIRST_HIT_RAY_BLOCK))
        ro = ray_o[:, rs, None, :]
        rd = ray_d[:, rs, None, :]
        bt, bface, bu, bv = (x[:, rs] for x in best)
        # chunks go in sorted order, so a tie with an earlier chunk's best
        # keeps the earlier face (strict <)
        for c0 in range(0, F, FIRST_HIT_CHUNK):
            cs = slice(c0, min(F, c0 + FIRST_HIT_CHUNK))
            pc = p[:, None, cs]  # [B, 1, C, 3, 3]
            tuv, nd = ray_tri_intersection(ro, rd, pc[..., 0, :],
                                           pc[..., 1, :], pc[..., 2, :])
            hit = strict_hit(tuv, nd) & valid_s[:, None, cs]
            key_t = torch.where(hit, tuv[..., 0], inf)
            min_t = key_t.min(dim=-1, keepdim=True).values
            # the first chunk position that holds the minimum
            cand = (hit & (key_t <= min_t)).to(torch.uint8).argmax(
                dim=-1, keepdim=True)
            c_t = key_t.gather(-1, cand)[..., 0]
            better = c_t < bt
            c_face = order[:, None, cs].expand(hit.shape).gather(-1, cand)
            bt.copy_(torch.where(better, c_t, bt))
            bface.copy_(torch.where(better, c_face[..., 0], bface))
            for b_x, k in ((bu, 1), (bv, 2)):
                b_x.copy_(torch.where(
                    better, tuv[..., k].gather(-1, cand)[..., 0], b_x))
    bt, bface, bu, bv = best
    miss = ~torch.isfinite(bt)
    return (torch.where(miss, -1, bface).to(torch.int32),
            torch.where(miss, 0.0, bt), bu, bv)


# =============================================================================
# March tables, start tets, projective depth
# =============================================================================

def _check_tensors(name, want, device):
    """Raise unless every (tensor, dtype, shape) of ``want`` has that dtype
    and shape and lies on ``device``: the kernel wrappers' argument
    checks."""
    for t, dtype, shape in want:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name}: all tensors must share a device")


def _plain_device(name, t) -> bool:
    """True where ``t`` is on the CPU (the plain version runs), False on
    CUDA (the kernel runs); raises on any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def _aligned(t, nbytes: int = 16):
    """``t`` contiguous, and copied where its data is not ``nbytes``-aligned
    (a kernel reads its rows as vectors)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % nbytes else t


def march_tables(verts, faces, tets, tet_faces, face_tets, verts_color,
                 faces_opacity, faces_intense):
    """The march's per-tet and per-(view, face) tables.

    Returns a dict: ``tet_geo`` [T, 40] f32 (p0, e1, e2 of the 4 face slots,
    then the outward sign of each slot: outward = sign * n-hat, from the
    side of the tet's centroid), ``tet_nrm`` [T, 12] f32 (each slot's
    outward unit normal sign * n-hat, which both walks read instead
    of rebuilding it), ``tet_ids`` [T, 8] int32 (the slots' face ids, then
    each slot's neighbour tet: the first entry of the face's ``face_tets``
    that is neither this tet nor -1), ``shade`` [B*F, 12] f32 (9 corner
    colours, alpha, log(max(1 - alpha, 1e-37)), the view's intensity), and
    ``geo`` [F, 12] (p0, e1, e2, n-hat) and ``sign`` [T, 4] for the start
    tet.

    On CUDA tensors this launches ``tet_tables`` of csrc/tet_tables.cu
    (int32 indices, f32 values; raises if it cannot), the same bits; on CPU
    tensors it runs ``march_tables_plain``."""
    args = (verts, faces, tets, tet_faces, face_tets, verts_color,
            faces_opacity, faces_intense)
    if _plain_device("march_tables", verts):
        return march_tables_plain(*args)
    return _tables_kernel(*args)


march_tables.launches = 0


def _tables_kernel(verts, faces, tets, tet_faces, face_tets, verts_color,
                   faces_opacity, faces_intense):
    """``march_tables`` by one launch of ``tet_tables``, after its argument
    checks."""
    P, F, T = verts.shape[0], faces.shape[0], tets.shape[0]
    B = faces_intense.shape[0]
    f32, i32 = torch.float32, torch.int32
    dev = verts.device
    _check_tensors("march_tables", (
        (verts, f32, (P, 3)), (faces, i32, (F, 3)), (tets, i32, (T, 4)),
        (tet_faces, i32, (T, 4)), (face_tets, i32, (F, 2)),
        (verts_color, f32, (P, 3)), (faces_opacity, f32, (F,)),
        (faces_intense, f32, (B, F))), dev)
    # tets and tet_faces are read as int4 rows, face_tets as int2
    tensors = [verts.contiguous(), faces.contiguous(), _aligned(tets),
               _aligned(tet_faces), _aligned(face_tets, 8),
               verts_color.contiguous(), faces_opacity.contiguous(),
               faces_intense.contiguous()]
    out = {"tet_geo": torch.empty((T, TET_GEO_COLS), dtype=f32, device=dev),
           "tet_nrm": torch.empty((T, TET_NRM_COLS), dtype=f32, device=dev),
           "tet_ids": torch.empty((T, TET_ID_COLS), dtype=i32, device=dev),
           "shade": torch.empty((B * F, SHADE_COLS), dtype=f32, device=dev),
           "geo": torch.empty((F, GEO_COLS), dtype=f32, device=dev),
           "sign": torch.empty((T, 4), dtype=f32, device=dev)}
    launch("tet_tables", "tet_tables",
           tensors + [out[k] for k in ("geo", "sign", "tet_geo", "tet_nrm",
                                       "tet_ids", "shade")], [F, T, B], dev)
    march_tables.launches += 1
    return out


def march_tables_plain(verts, faces, tets, tet_faces, face_tets,
                       verts_color, faces_opacity, faces_intense):
    """Plain torch version of ``march_tables``: the same inputs and outputs
    (any index dtype)."""
    F = faces.shape[0]
    T = tets.shape[0]
    B = faces_intense.shape[0]
    fl = faces.long()
    gv = verts[fl]  # [F, 3, 3]
    p0 = gv[:, 0]
    e1 = gv[:, 1] - p0
    e2 = gv[:, 2] - p0
    n = cross(e1, e2)
    sq = n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2]
    norm = sqrt_rn(sq)  # correctly rounded, as the kernel's sqrtf
    norm = torch.maximum(norm, torch.full_like(norm, 1e-4))
    nhat = n / norm[:, None]
    geo = torch.cat([p0, e1, e2, nhat], dim=1)  # [F, 12]

    tf = tet_faces.long().clamp_min(0)  # [T, 4]
    tv = verts[tets.long()]  # [T, 4, 3]
    centers = (tv[:, 0] + tv[:, 1] + tv[:, 2] + tv[:, 3]) / torch.full_like(
        tv[:, 0], 4.0)
    geo_tf = geo[tf]  # [T, 4, 12]
    off = centers[:, None, :] - geo_tf[..., 0:3]
    flip = (geo_tf[..., 9] * off[..., 0] + geo_tf[..., 10] * off[..., 1]
            + geo_tf[..., 11] * off[..., 2]) > 0.0
    sign = torch.where(flip, -1.0, 1.0)  # [T, 4]

    ft2 = face_tets.long()[tf]  # [T, 4, 2]
    tidx = torch.arange(T, device=verts.device)[:, None]
    c0, c1 = ft2[..., 0], ft2[..., 1]
    ok0 = (c0 != tidx) & (c0 != -1)
    ok1 = (c1 != tidx) & (c1 != -1)
    nbr = torch.where(ok0, c0, torch.where(ok1, c1, -1))

    tet_geo = torch.cat([geo_tf[..., 0:9].reshape(T, 36), sign], dim=1)
    # n-hat is the walk's normal bit for bit (the same cross product, root,
    # clamp and divide), and a sign of +-1 multiplies exactly, so a dot
    # with this row rounds as sign * (n-hat . d) does
    tet_nrm = (sign[..., None] * geo_tf[..., 9:12]).reshape(T, TET_NRM_COLS)
    tet_ids = torch.cat([tet_faces.long(), nbr], dim=1).to(torch.int32)

    col9 = verts_color[fl].reshape(F, 9)
    one_m_a = 1.0 - faces_opacity
    log1ma = torch.log(torch.maximum(one_m_a, torch.full_like(one_m_a, 1e-37)))
    base = torch.cat([col9, faces_opacity[:, None], log1ma[:, None]], dim=1)
    shade = torch.cat([base[None].expand(B, F, 11), faces_intense[..., None]],
                      dim=-1).reshape(B * F, SHADE_COLS)
    return {"tet_geo": tet_geo.contiguous(), "tet_nrm": tet_nrm.contiguous(),
            "tet_ids": tet_ids.contiguous(),
            "shade": shade.contiguous(), "geo": geo, "sign": sign}


def start_tets_plain(first_face, ray_d, geo, sign, face_tets, tet_faces):
    """The tet each ray enters at its first hit [M] int32 (-1: none): of
    the first face's two tets, the one whose outward normal of that face
    opposes the ray; when both qualify the second wins. Plain torch: the CPU
    path of ``ray_start`` and the card kernel's reference.

    first_face [M] int32; ray_d [M, 3]; ``geo``/``sign`` of
    ``march_tables``."""
    ff = first_face.long()
    ffs = ff.clamp_min(0)
    g = geo[ffs]
    ndot = g[:, 9] * ray_d[:, 0] + g[:, 10] * ray_d[:, 1] + g[:, 11] * ray_d[:, 2]
    ftc = face_tets.long()[ffs]  # [M, 2]
    first_tet = torch.full_like(ff, -1)
    for i in range(2):
        cand = ftc[:, i]
        cs = cand.clamp_min(0)
        cf, csg = tet_faces.long()[cs], sign[cs]  # [M, 4]
        # at most one slot of a tet holds the face: the masked sum is its
        # sign
        sgn = torch.where(cf[:, 0] == ff, csg[:, 0], 0.0)
        for j in range(1, 4):
            sgn = sgn + torch.where(cf[:, j] == ff, csg[:, j], 0.0)
        take = (cand >= 0) & (sgn * ndot < 0.0) & (ff >= 0)
        first_tet = torch.where(take, cand, first_tet)
    return first_tet.to(torch.int32)


def projective_zw_plain(cam_o, ray_d, mv_t, proj_t):
    """z and w of the homogeneous point proj(mv(o + t d)) as affine
    functions of t, per ray: [B*N, 4] (z at 0, w at 0, dz/dt, dw/dt), in
    the JAX package's operation order. cam_o [B, 3]; ray_d [B, N, 3];
    mv_t/proj_t [B, 4, 4] transposed. Plain torch: the CPU path of
    ``ray_start`` and the card kernel's reference."""
    B, N = ray_d.shape[:2]
    ro = [cam_o[:, k, None] for k in range(3)]  # [B, 1]
    rd = [ray_d[..., k] for k in range(3)]  # [B, N]
    mv = lambda j, i: mv_t[:, j, i, None]
    pj = lambda j, i: proj_t[:, j, i, None]
    pvo = [ro[0] * mv(0, i) + ro[1] * mv(1, i) + ro[2] * mv(2, i) + mv(3, i)
           for i in range(3)]
    dv = [rd[0] * mv(0, i) + rd[1] * mv(1, i) + rd[2] * mv(2, i)
          for i in range(3)]
    phoz = pvo[0] * pj(0, 2) + pvo[1] * pj(1, 2) + pvo[2] * pj(2, 2) + pj(3, 2)
    phow = pvo[0] * pj(0, 3) + pvo[1] * pj(1, 3) + pvo[2] * pj(2, 3) + pj(3, 3)
    phdz = dv[0] * pj(0, 2) + dv[1] * pj(1, 2) + dv[2] * pj(2, 2)
    phdw = dv[0] * pj(0, 3) + dv[1] * pj(1, 3) + dv[2] * pj(2, 3)
    return torch.stack([phoz.expand(B, N), phow.expand(B, N), phdz, phdw],
                       dim=-1).reshape(B * N, 4)


def ray_start(first_face, ray_d, t, u, v, cam_o, mv_t, proj_t, geo, sign,
              face_tets, tet_faces):
    """K4's per-ray inputs: (first_tet [M] int32 of ``start_tets_plain``,
    zw [M, 4] f32 of ``projective_zw_plain``, tuv [3, M] f32: the first
    hit's t, u, v). first_face [M] int32; ray_d [M, 3] (M = B * N,
    view-major); t, u, v of M elements each; cam_o [B, 3]; mv_t/proj_t
    [B, 4, 4] transposed; geo, sign of ``march_tables``; face_tets [F, 2],
    tet_faces [T, 4] int32.

    On CUDA tensors this is one launch of ``tet_ray_start`` of
    csrc/tet_tables.cu (int32 indices, f32 values; raises if it cannot),
    the same bits; on CPU tensors the two plain versions and a stack."""
    if _plain_device("ray_start", ray_d):
        M, B = ray_d.shape[0], cam_o.shape[0]
        return (start_tets_plain(first_face, ray_d, geo, sign, face_tets,
                                 tet_faces),
                projective_zw_plain(cam_o, ray_d.reshape(B, M // B, 3), mv_t,
                                    proj_t),
                torch.stack([x.reshape(M) for x in (t, u, v)]))
    return _ray_start_kernel(first_face, ray_d, t, u, v, cam_o, mv_t, proj_t,
                             geo, sign, face_tets, tet_faces)


ray_start.launches = 0


def _ray_start_kernel(first_face, ray_d, t, u, v, cam_o, mv_t, proj_t, geo,
                      sign, face_tets, tet_faces):
    """``ray_start`` by one launch of ``tet_ray_start``, after its argument
    checks."""
    M, B = ray_d.shape[0], cam_o.shape[0]
    F, T = geo.shape[0], sign.shape[0]
    hit = [x.reshape(M) for x in (t, u, v)]
    dev = ray_d.device
    f32, i32 = torch.float32, torch.int32
    _check_tensors("ray_start", (
        (first_face, i32, (M,)), (ray_d, f32, (M, 3)),
        *((x, f32, (M,)) for x in hit), (cam_o, f32, (B, 3)),
        (mv_t, f32, (B, 4, 4)), (proj_t, f32, (B, 4, 4)),
        (geo, f32, (F, GEO_COLS)), (sign, f32, (T, 4)),
        (face_tets, i32, (F, 2)), (tet_faces, i32, (T, 4))), dev)
    if B == 0 or M % B:
        raise ValueError(f"ray_start: {M} rays for {B} views")
    # geo, sign and tet_faces are read as 16-byte rows, face_tets as int2
    tensors = [first_face.contiguous(), ray_d.contiguous(),
               *(x.contiguous() for x in hit),
               *(x.contiguous() for x in (cam_o, mv_t, proj_t)),
               _aligned(geo), _aligned(sign), _aligned(face_tets, 8),
               _aligned(tet_faces)]
    out = (torch.empty((M,), dtype=i32, device=dev),
           torch.empty((M, 4), dtype=f32, device=dev),
           torch.empty((3, M), dtype=f32, device=dev))
    launch("tet_tables", "tet_ray_start", tensors + list(out), [M, M // B],
           dev)
    ray_start.launches += 1
    return out


# =============================================================================
# The march (kernel K4)
# =============================================================================

def _check_march_args(ray_d, cam_o, zw, first_face, first_tet, tuv, tet_geo,
                      tet_nrm, tet_ids, shade, H, W):
    M = ray_d.shape[0]
    B = cam_o.shape[0]
    T = tet_geo.shape[0]
    want = ((ray_d, torch.float32, (M, 3)), (cam_o, torch.float32, (B, 3)),
            (zw, torch.float32, (M, 4)), (first_face, torch.int32, (M,)),
            (first_tet, torch.int32, (M,)), (tuv, torch.float32, (3, M)),
            (tet_geo, torch.float32, (T, TET_GEO_COLS)),
            (tet_nrm, torch.float32, (T, TET_NRM_COLS)),
            (tet_ids, torch.int32, (T, TET_ID_COLS)),
            (shade, torch.float32, (shade.shape[0], SHADE_COLS)))
    _check_tensors("fwd_march", want, ray_d.device)
    if M != B * H * W or shade.shape[0] % B:
        raise ValueError(f"fwd_march: {M} rays for {B} views of {H}x{W}, "
                         f"shade rows {shade.shape[0]}")


def fwd_march(ray_d, cam_o, zw, first_face, first_tet, tuv, tet_geo, tet_nrm,
              tet_ids, shade, H: int, W: int,
              max_steps: int = DEFAULT_MAX_MARCH_STEPS):
    """March every ray through the tets from its first hit (kernel K4).

    ray_d [M, 3] (M = B * H * W rays, view-major, each view's pixels
    row-major); cam_o [B, 3]; zw [M, 4]
    (``ray_start``); first_face, first_tet [M] int32 (-1: the ray does
    not march); tuv [3, M] f32, the first hit's t, u, v; the tables of
    ``march_tables``. At most ``max_steps`` faces are blended per ray.
    Returns (out_f [6, M] f32: C rgb, D, log T, the log T before the last
    blend; out_i [4, M] int32: last face, last tet, n_contrib, active).

    On CUDA tensors this launches the kernel of csrc/tet_fwd.cu (and raises
    if it cannot); on CPU tensors it runs ``fwd_march_plain``."""
    args = (ray_d, cam_o, zw, first_face, first_tet, tuv, tet_geo, tet_nrm,
            tet_ids, shade)
    _check_march_args(*args, H, W)
    if _plain_device("fwd_march", ray_d):
        return fwd_march_plain(*args, H, W, max_steps)
    # zw and the tables are read as 16-byte rows
    tensors = [_aligned(x) if j in (2, 6, 7, 8, 9) else x.contiguous()
               for j, x in enumerate(args)]
    M = ray_d.shape[0]
    B = cam_o.shape[0]
    F = shade.shape[0] // B
    dev = ray_d.device
    out_f = torch.empty((6, M), dtype=torch.float32, device=dev)
    out_i = torch.empty((4, M), dtype=torch.int32, device=dev)
    launch("tet_fwd", "tet_fwd_march", tensors + [out_f, out_i],
           [B, H, W, F, int(max_steps), LOG_T_FLOOR], dev)
    fwd_march.launches += 1
    return out_f, out_i


fwd_march.launches = 0


def _moller_trumbore(p0, e1, e2, o, d):
    """Moller-Trumbore of rays (origin ``o``, direction ``d``) against
    triangles (corner ``p0``, edges ``e1``, ``e2``), each a 3-list of [L]:
    (t, u, v, denom != 0), the kernels' arithmetic in their order."""
    dx, dy, dz = d
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    tvx, tvy, tvz = o[0] - p0[0], o[1] - p0[1], o[2] - p0[2]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    denom = pvx * e1x + pvy * e1y + pvz * e1z
    nd = denom != 0.0
    inv = torch.reciprocal(torch.where(nd, denom, 1.0))
    t = (qvx * e2x + qvy * e2y + qvz * e2z) * inv
    u = (pvx * tvx + pvy * tvy + pvz * tvz) * inv
    v = (qvx * dx + qvy * dy + qvz * dz) * inv
    return t, u, v, nd


def _walk(g, ids, cf, o, d, direction: int = 1, nrm=None):
    """One connectivity step for [L] rays: their tet's rows ``g`` [L, 40]
    and ``ids`` [L, 8], current face ``cf`` [L], origin ``o`` and direction
    ``d`` (3-lists of [L]). ``direction`` +1 walks forward (the exit face's
    outward normal has a positive dot with the ray, the entry face's a
    negative one), -1 backward (both signs flipped). ``nrm`` [L, 12], the
    tet's ``tet_nrm`` row, gives the outward normals (K4's and K5's walk);
    without it they are rebuilt from ``g``, to the same bits. Returns (err,
    next face, next tet, t, u, v), the kernels' per-slot arithmetic in their
    order (csrc/tet_walk.cuh)."""
    dx, dy, dz = d
    L = cf.shape[0]
    n_other = torch.zeros(L, dtype=torch.int32, device=cf.device)
    n_exit = torch.zeros_like(n_other)
    d_entry = torch.zeros(L, dtype=torch.float32, device=cf.device)
    for j in range(4):
        p0 = [g[:, 9 * j + k] for k in range(3)]
        e1 = [g[:, 9 * j + 3 + k] for k in range(3)]
        e2x, e2y, e2z = e2 = [g[:, 9 * j + 6 + k] for k in range(3)]
        e1x, e1y, e1z = e1
        sgn = g[:, 36 + j]
        tfj, nbj = ids[:, j], ids[:, 4 + j]

        if nrm is None:
            nx = e1y * e2z - e1z * e2y
            ny = e1z * e2x - e1x * e2z
            nz = e1x * e2y - e1y * e2x
            norm = sqrt_rn(nx * nx + ny * ny + nz * nz)
            norm = torch.maximum(norm, torch.full_like(norm, 1e-4))
            outd = sgn * ((nx / norm) * dx + (ny / norm) * dy
                          + (nz / norm) * dz)
        else:
            outd = (nrm[:, 3 * j] * dx + nrm[:, 3 * j + 1] * dy
                    + nrm[:, 3 * j + 2] * dz)

        t, u, v, nd = _moller_trumbore(p0, e1, e2, o, d)
        hit = nd & (t >= 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)

        is_entry = tfj == cf
        n_other = n_other + (~is_entry).to(torch.int32)
        d_entry = d_entry + torch.where(is_entry, outd, 0.0)
        dir_ok = outd > 0.0 if direction > 0 else outd < 0.0
        ex = ~is_entry & hit & dir_ok
        n_exit = n_exit + ex.to(torch.int32)
        if j == 0:
            nt_, nu_, nv_, nface, ntet = t, u, v, tfj, nbj
        else:
            nt_ = torch.where(ex, t, nt_)
            nu_ = torch.where(ex, u, nu_)
            nv_ = torch.where(ex, v, nv_)
            nface = torch.where(ex, tfj, nface)
            ntet = torch.where(ex, nbj, ntet)
    entry_bad = d_entry >= 0.0 if direction > 0 else d_entry <= 0.0
    err = (n_other != 3) | entry_bad | (n_exit != 1)
    return err, nface, ntet, nt_, nu_, nv_


def fwd_march_plain(ray_d, cam_o, zw, first_face, first_tet, tuv, tet_geo,
                    tet_nrm, tet_ids, shade, H: int, W: int,
                    max_steps: int = DEFAULT_MAX_MARCH_STEPS):
    """Plain torch version of ``fwd_march``: the same inputs, outputs and
    per-ray f32 arithmetic, vectorised over the rays that are still
    marching and sequential over the steps."""
    dev = ray_d.device
    M = ray_d.shape[0]
    F = shade.shape[0] // cam_o.shape[0]
    view = torch.arange(M, device=dev) // (H * W)
    f32 = dict(dtype=torch.float32, device=dev)
    C = [torch.zeros(M, **f32) for _ in range(4)]  # r, g, b, D
    log_T = torch.zeros(M, **f32)
    T_cur = torch.ones(M, **f32)
    plt = torch.zeros(M, **f32)
    last_face = torch.full((M,), -1, dtype=torch.int32, device=dev)
    last_tet = torch.full_like(last_face, -1)
    n_contrib = torch.zeros_like(last_face)
    active = torch.zeros_like(last_face)
    cf, ct = first_face.clone(), first_tet.clone()
    t, u, v = tuv[0].clone(), tuv[1].clone(), tuv[2].clone()
    floor = torch.tensor(LOG_T_FLOOR, **f32)

    live = torch.nonzero((cf != -1) & (ct != -1)).squeeze(1)
    for _step in range(int(max_steps)):
        if live.numel() == 0:
            break
        vw = view[live]
        cfl, ctl = cf[live], ct[live]
        tl, ul, vl = t[live], u[live], v[live]
        sh = shade[vw * F + cfl.long()]
        alpha, l1a, inten = sh[:, 9], sh[:, 10], sh[:, 11]
        w = T_cur[live] * alpha
        for ch in range(3):
            col = (sh[:, ch] + (sh[:, 3 + ch] - sh[:, ch]) * ul
                   + (sh[:, 6 + ch] - sh[:, ch]) * vl) * inten
            C[ch][live] = C[ch][live] + col * w
        z = zw[live]
        dep = (z[:, 0] + tl * z[:, 2]) / clamp_w(z[:, 1] + tl * z[:, 3])
        C[3][live] = C[3][live] + dep * w
        lt_old = log_T[live]
        plt[live] = lt_old
        lt_new = torch.where(alpha < 1.0, lt_old + l1a, floor)
        log_T[live] = lt_new
        tc = torch.exp(lt_new)
        T_cur[live] = tc
        last_face[live] = cfl
        last_tet[live] = ctl
        n_contrib[live] += 1

        term = (tc < T_EPS) | (ctl == -1)
        active[live[term]] = 1
        keep = ~term
        live, ctl, cfl, vw = live[keep], ctl[keep], cfl[keep], vw[keep]
        ctl = ctl.long()
        o = [cam_o[vw, k] for k in range(3)]
        d = [ray_d[live, k] for k in range(3)]
        err, nf, nt, t2, u2, v2 = _walk(tet_geo[ctl], tet_ids[ctl], cfl, o,
                                        d, nrm=tet_nrm[ctl])
        ok = ~err
        live = live[ok]
        cf[live], ct[live] = nf[ok], nt[ok]
        t[live], u[live], v[live] = t2[ok], u2[ok], v2[ok]
    return (torch.stack(C + [log_T, plt]),
            torch.stack([last_face, last_tet, n_contrib, active]))


# =============================================================================
# The forward
# =============================================================================


def render_tet_forward(verts, faces, verts_color, faces_opacity, mv_t,
                       proj_t, inv_mv_t, inv_proj_t, faces_intense, tets,
                       face_tets, tet_faces, bg, height: int, width: int,
                       seed: int, max_steps: int = DEFAULT_MAX_MARCH_STEPS,
                       kcap: int | None = None, view_offset=None):
    """The tet forward. Returns (color [B, 3, H, W], depth [B, 1, H, W],
    active [B, H, W] bool, saved): ``saved`` holds the per-ray state a
    backward needs -- first_face, last_face, last_tet, n_contrib [B, N]
    int32, final_log_T, final_prev_log_T [B, N] f32, is_active [B, N] bool
    -- the march's inputs that the backward's re-walk reads again (ray_d
    [B*N, 3], cam_o [B, 3], zw [B*N, 4], march: the ``march_tables``) and
    the first hit's aux (fh_overflow, fh_num_rendered, fh_walked; False,
    -1, -1 on the dense path), and the static ``record_capacity`` of the
    backward's records -- or, where an eager frame read a record total
    above it, that total (the exact fallback; module docstring)."""
    from .tet_first_hit import first_intersection_binned

    B = mv_t.shape[0]
    F = faces.shape[0]
    N = height * width
    dev = verts.device
    threshold = (BINNED_FIRST_HIT_THRESHOLD if dev.type == "cpu"
                 else BINNED_FIRST_HIT_THRESHOLD_GPU)
    use_binned = F > threshold

    ndc, img = project_verts(verts, mv_t, proj_t, width, height)
    tile = BIN_TILE if use_binned else TILE_X
    pre = preprocess_faces(ndc, img, faces, width, height, tile, tile)
    ray_o, ray_d_img = generate_rays(
        inv_mv_t, inv_proj_t, width, height, norm_eps_mode="tet",
        jitter_seed=seed if seed > 0 else None, view_offset=view_offset)
    ray_d = ray_d_img.reshape(B, N, 3)
    cam_o = inv_mv_t[:, 3, :3].contiguous()

    if use_binned:
        if kcap is None:
            kcap = default_key_capacity(B, F, avg_tiles_per_face=5)
        first_face, rt, iu, iv, fh_aux = first_intersection_binned(
            verts, faces, pre, cam_o, ray_d_img, height, width, B, kcap)
    else:
        key = torch.where(pre["valid"], pre["min_depth"], math.inf)
        order = torch.sort(key, dim=1, stable=True).indices
        first_face, rt, iu, iv = first_intersection_dense(
            verts, faces, pre["valid"], order, ray_o.reshape(B, N, 3), ray_d)
        # the dense path scans every valid face: no capacity, cannot drop
        fh_aux = (torch.zeros((), dtype=torch.bool, device=dev),
                  torch.full((), -1, device=dev),
                  torch.full((), -1, device=dev))
    spans.mark("tet.first_hit", fh_aux[1])

    march = march_tables(verts, faces, tets, tet_faces, face_tets,
                         verts_color, faces_opacity, faces_intense)
    M = B * N
    rd_flat = ray_d.reshape(M, 3)
    ff_flat = first_face.reshape(M)
    first_tet, zw, tuv = ray_start(ff_flat, rd_flat, rt, iu, iv, cam_o, mv_t,
                                   proj_t, march["geo"], march["sign"],
                                   face_tets, tet_faces)
    spans.mark("tet.tables")
    out_f, out_i = fwd_march(rd_flat, cam_o, zw, ff_flat, first_tet, tuv,
                             march["tet_geo"], march["tet_nrm"],
                             march["tet_ids"], march["shade"], height, width,
                             max_steps)

    act = out_i[3] != 0
    # the frame's one host read (none under a capture): the first hit's
    # overflow and pair count, and the backward's record total
    cap = record_capacity(B, height, width, max_steps)
    read = warn_if_overflow(
        fh_aux[0], fh_aux[1], kcap, FH_OVERFLOW_CONTEXT,
        extra=(_record_counts(act, out_i[0], out_i[2]).sum(),),
        settings="TetRenderSettings")
    if read is not None:
        cap = max(cap, read[0])
    final_T = torch.exp(out_f[4])
    col = [torch.where(act, out_f[ch] + final_T * bg[ch], bg[ch])
           for ch in range(3)]
    color = torch.stack(col).reshape(3, B, height, width).transpose(0, 1)
    depth = torch.where(act, out_f[3] + final_T * 1.0, 1.0).reshape(
        B, 1, height, width)
    shape2 = lambda x: x.reshape(B, N)
    saved = dict(
        first_face=first_face,
        last_face=shape2(out_i[0]),
        last_tet=shape2(out_i[1]),
        final_log_T=shape2(out_f[4]),
        final_prev_log_T=shape2(out_f[5]),
        n_contrib=shape2(out_i[2]),
        is_active=shape2(act),
        ray_d=rd_flat,
        cam_o=cam_o,
        zw=zw,
        march=march,
        record_capacity=cap,
        fh_overflow=fh_aux[0],
        fh_num_rendered=fh_aux[1],
        fh_walked=fh_aux[2],
    )
    color = color.contiguous()
    spans.mark("tet.k4")
    return color, depth, act.reshape(B, height, width), saved


# =============================================================================
# The backward march (kernel K5)
# =============================================================================

def record_capacity(B: int, height: int, width: int, max_steps: int) -> int:
    """Rows of K5's record buffers: B * H * W * min(``LOG_CAP``,
    ``max_steps``), the JAX package's static bound for the backward."""
    return B * height * width * min(LOG_CAP, int(max_steps))


def _record_counts(active, last_face, n_contrib):
    """Each ray's record count: ``n_contrib``, or 0 for a ray that is
    inactive or blended nothing."""
    return torch.where(active & (last_face != -1), n_contrib, 0).long()


def bwd_start_state(saved, face_tets, dL_dcolor, dL_ddepth, bg):
    """Each ray's start state for the backward march, from the forward's
    ``saved`` and the upstream gradients dL/dcolor [B, 3, H, W] and
    dL/ddepth [B, 1, H, W].

    A ray re-walks from its last face, inside the tet before that face (the
    first entry of the face's ``face_tets`` that is not the forward's last
    tet), with t/u/v from Moller-Trumbore on the face. A ray that is
    inactive or blended nothing gets no records; every other ray gets
    ``n_contrib`` slots, at the exclusive sum of the counts before it,
    unless they pass ``saved["record_capacity"]``: then it gets none.
    Returns (ray_i [4, M] int32: start face, start tet, first face, record
    count; ray_f [11, M] f32: t, u, v, the log T before the start face,
    dL/dC rgb, dL/dD, bg . dL/dC + dL/dD, final T, final prev T; off [M]
    int64, the first slot of each ray; the record capacity, an int; the
    number of records, a 0-d int64 tensor; and overflow, a 0-d bool
    tensor: the records passed the capacity). No host read."""
    B, N = saved["last_face"].shape
    M = B * N
    dev = bg.device
    lf = saved["last_face"].reshape(M)
    lfs = lf.long().clamp_min(0)
    g = saved["march"]["geo"][lfs]
    o = saved["cam_o"][torch.arange(M, device=dev) // N]
    d = saved["ray_d"]
    t0, u0, v0, _nd = _moller_trumbore(
        [g[:, k] for k in range(3)], [g[:, 3 + k] for k in range(3)],
        [g[:, 6 + k] for k in range(3)], [o[:, k] for k in range(3)],
        [d[:, k] for k in range(3)])
    ftc = face_tets[lfs]
    start_tet = torch.where(ftc[:, 0] != saved["last_tet"].reshape(M),
                            ftc[:, 0], ftc[:, 1])
    n64 = _record_counts(saved["is_active"].reshape(M), lf,
                         saved["n_contrib"].reshape(M))
    off = torch.cumsum(n64, 0) - n64
    cap = saved["record_capacity"]
    total = n64.sum()
    n_rec = torch.where(off + n64 <= cap, n64, 0)
    gc = [dL_dcolor[:, ch].reshape(M) for ch in range(3)]
    gdep = dL_ddepth[:, 0].reshape(M)
    bg_dot = bg[0] * gc[0] + bg[1] * gc[1] + bg[2] * gc[2] + gdep
    plt = saved["final_prev_log_T"].reshape(M)
    ray_f = torch.stack([t0, u0, v0, plt, *gc, gdep, bg_dot,
                         torch.exp(saved["final_log_T"].reshape(M)),
                         torch.exp(plt)])
    ray_i = torch.stack([lf, start_tet, saved["first_face"].reshape(M),
                         n_rec]).to(torch.int32)
    return (ray_i.contiguous(), ray_f.contiguous(), off, cap, total,
            total > cap)


def _check_bwd_args(ray_d, cam_o, zw, ray_i, ray_f, off, tet_geo, tet_nrm,
                    tet_ids, shade, N):
    M = ray_d.shape[0]
    B = cam_o.shape[0]
    T = tet_geo.shape[0]
    want = ((ray_d, torch.float32, (M, 3)), (cam_o, torch.float32, (B, 3)),
            (zw, torch.float32, (M, 4)),
            (ray_i, torch.int32, (RAY_I_ROWS, M)),
            (ray_f, torch.float32, (RAY_F_ROWS, M)),
            (off, torch.int64, (M,)),
            (tet_geo, torch.float32, (T, TET_GEO_COLS)),
            (tet_nrm, torch.float32, (T, TET_NRM_COLS)),
            (tet_ids, torch.int32, (T, TET_ID_COLS)),
            (shade, torch.float32, (shade.shape[0], SHADE_COLS)))
    _check_tensors("bwd_march", want, ray_d.device)
    if M != B * N or shade.shape[0] % B:
        raise ValueError(f"bwd_march: {M} rays for {B} views of {N}, shade "
                         f"rows {shade.shape[0]}")


def bwd_march(ray_d, cam_o, zw, ray_i, ray_f, off, n_records: int, tet_geo,
              tet_nrm, tet_ids, shade, N: int):
    """Re-walk every ray from its last face back to its first (kernel K5)
    and write one gradient record per visited face.

    ray_d [M, 3], cam_o [B, 3], zw [M, 4] as for ``fwd_march``; ray_i,
    ray_f, off and ``n_records`` (the record capacity R) from
    ``bwd_start_state``; the tables of ``march_tables``. Returns (keys [R]
    int32: the face of each record, F for a slot the re-walk did not fill
    and for the slots past the records; rec [R, 10] f32: the nine colour
    moments, vertex-major, and dL/dalpha; bad [M] uint8: 1 where the
    re-walk did not retrace the forward, that is, it broke, left the mesh,
    or did not meet the first face at exactly the ray's last slot). The
    number of such rays of the last call is ``bwd_march.mismatches``, a
    0-d tensor on the call's device. The card leaves the rows of ``rec``
    past the records unwritten; their key F keeps them out of the reduce.

    On CUDA tensors this launches the kernel of csrc/tet_bwd.cu (and raises
    if it cannot); on CPU tensors it runs ``bwd_march_plain``."""
    args = (ray_d, cam_o, zw, ray_i, ray_f, off, tet_geo, tet_nrm, tet_ids,
            shade)
    _check_bwd_args(*args, N)
    if _plain_device("bwd_march", ray_d):
        out = bwd_march_plain(*args[:6], n_records, *args[6:], N)
        bwd_march.mismatches = out[2].sum()
        return out
    # zw and the tables are read as 16-byte rows
    tensors = [_aligned(x) if j in (2, 6, 7, 8, 9) else x.contiguous()
               for j, x in enumerate(args)]
    M = ray_d.shape[0]
    F = shade.shape[0] // cam_o.shape[0]
    dev = ray_d.device
    keys = torch.full((n_records,), F, dtype=torch.int32, device=dev)
    rec = torch.empty((n_records, REC_COLS), dtype=torch.float32, device=dev)
    bad = torch.empty((M,), dtype=torch.uint8, device=dev)
    launch("tet_bwd", "tet_bwd_march", tensors + [keys, rec, bad], [M, N, F],
           dev)
    bwd_march.launches += 1
    bwd_march.mismatches = bad.sum()
    return keys, rec, bad


bwd_march.launches = 0
bwd_march.mismatches = None


def bwd_march_plain(ray_d, cam_o, zw, ray_i, ray_f, off, n_records: int,
                    tet_geo, tet_nrm, tet_ids, shade, N: int):
    """Plain torch version of ``bwd_march``: the same inputs, outputs and
    per-ray f32 arithmetic, vectorised over the rays that are still walking
    and sequential over the visits."""
    dev = ray_d.device
    M = ray_d.shape[0]
    F = shade.shape[0] // cam_o.shape[0]
    view = torch.arange(M, device=dev) // N
    keys = torch.full((n_records,), F, dtype=torch.int32, device=dev)
    rec = torch.zeros((n_records, REC_COLS), dtype=torch.float32, device=dev)
    bad = (ray_i[3] > 0).to(torch.uint8)
    cf, ct = ray_i[0].clone(), ray_i[1].clone()
    first_face, n_rec = ray_i[2], ray_i[3]
    t, u, v, plt = (ray_f[r].clone() for r in range(4))
    gc = [ray_f[r] for r in range(4, 8)]  # dL/dC rgb, dL/dD
    bgd, fT, fpT = ray_f[8], ray_f[9], ray_f[10]
    la = torch.zeros(M, dtype=torch.float32, device=dev)
    last = [torch.zeros_like(la) for _ in range(4)]  # colour rgb, depth
    acc = [torch.zeros_like(la) for _ in range(4)]

    live = torch.nonzero(n_rec > 0).squeeze(1)
    k = 0
    while live.numel():
        vw, cfl, ctl = view[live], cf[live], ct[live]
        sh = shade[vw * F + cfl.long()]
        alpha, l1a, inten = sh[:, 9], sh[:, 10], sh[:, 11]
        i1, i2, tl = u[live], v[live], t[live]
        i0 = 1.0 - i1 - i2
        col = [(i0 * sh[:, ch] + i1 * sh[:, 3 + ch] + i2 * sh[:, 6 + ch])
               * inten for ch in range(3)]
        z = zw[live]
        dep = (z[:, 0] + tl * z[:, 2]) / clamp_w(z[:, 1] + tl * z[:, 3])
        pl = plt[live] if k == 0 else plt[live] - l1a
        plt[live] = pl
        prev_T = torch.exp(pl)
        lal = la[live]
        acc_new = [lal * last[j][live] + (1.0 - lal) * acc[j][live]
                   for j in range(4)]
        g = [x[live] for x in gc]
        dL = ((col[0] - acc_new[0]) * g[0] + (col[1] - acc_new[1]) * g[1]
              + (col[2] - acc_new[2]) * g[2]
              + (dep - acc_new[3]) * g[3]) * prev_T
        bg_coef = torch.where(
            alpha == 1.0, -fpT[live],
            -fT[live] / torch.clamp_min(1.0 - alpha, 1e-37))
        dL = dL + bg_coef * bgd[live]
        wmask = inten * prev_T * alpha
        vals = [wmask * b * g[ch] for b in (i0, i1, i2) for ch in range(3)]
        slot = off[live] + k
        rec[slot] = torch.stack(vals + [dL], dim=1)
        keys[slot] = cfl
        k += 1
        la[live] = alpha
        for j, x in enumerate(col + [dep]):
            last[j][live] = x
            acc[j][live] = acc_new[j]

        # stop at the first face or past the mesh, else walk back
        at_first = cfl == first_face[live]
        done = live[at_first]
        bad[done] = (n_rec[done] != k).to(torch.uint8)
        go = ~at_first & (ctl != -1) & (n_rec[live] > k)
        live, ctl, cfl, vw = live[go], ctl[go], cfl[go], vw[go]
        gt, ids = tet_geo[ctl.long()], tet_ids[ctl.long()]
        o = [cam_o[vw, j] for j in range(3)]
        d = [ray_d[live, j] for j in range(3)]
        err, nf, nt, t2, u2, v2 = _walk(gt, ids, cfl, o, d, direction=-1,
                                        nrm=tet_nrm[ctl.long()])
        live = live[~err]
        ok = ~err
        cf[live], ct[live] = nf[ok], nt[ok]
        t[live], u[live], v[live] = t2[ok], u2[ok], v2[ok]
    return keys, rec, bad


def reduce_tet_records(keys, rec, faces, n_verts: int):
    """K5's records -> (g_vcolor [P, 3], g_fopacity [F]): the records summed
    per face in slot order, then the nine colour moments of each face summed
    per vertex, both by ``seg_sum``. The rows of key F (the absorber, and
    the capacity's rows past the records) lie past every segment of
    ``segment_csr(keys, F)``, so ``seg_sum`` never reads them."""
    F = faces.shape[0]
    face_acc = seg_sum(rec, segment_csr(keys, F))
    g_vcolor = corner_sum(faces, n_verts,
                          face_acc[:, :9].reshape(F * 3, 3))
    return g_vcolor, face_acc[:, 9].contiguous()


def render_tet_backward(saved, faces, face_tets, bg, n_verts: int,
                        dL_dcolor, dL_ddepth):
    """The gradients of ``verts_color`` [P, 3] and ``faces_opacity`` [F]
    from the forward's ``saved`` and the upstream gradients. Sets
    ``render_tet_backward.overflow``, a 0-d bool tensor on the device: the
    records passed the capacity and the gradients miss some (only ever
    under a capture; module docstring)."""
    ray_i, ray_f, off, n_records, total, overflow = bwd_start_state(
        saved, face_tets, dL_dcolor, dL_ddepth, bg)
    spans.mark("tet.bwd_start", total)
    render_tet_backward.overflow = overflow
    m = saved["march"]
    keys, rec, _bad = bwd_march(saved["ray_d"], saved["cam_o"], saved["zw"],
                                ray_i, ray_f, off, n_records, m["tet_geo"],
                                m["tet_nrm"], m["tet_ids"], m["shade"],
                                saved["last_face"].shape[1])
    spans.mark("tet.k5")
    out = reduce_tet_records(keys, rec, faces, n_verts)
    spans.mark("tet.reduce")
    return out


render_tet_backward.overflow = None

# what the backward reads of the forward's ``saved``
_BWD_SAVED = ("first_face", "last_face", "last_tet", "n_contrib",
              "final_log_T", "final_prev_log_T", "is_active", "ray_d",
              "cam_o", "zw", "march", "record_capacity")
# the float inputs of _RenderTet that get zero gradients
_ZERO_GRAD_INPUTS = (0, 4, 5, 6, 7, 8, 12)


class _RenderTet(torch.autograd.Function):
    """The tet renderer as an autograd Function. The forward keeps the
    per-ray state, the rays and the march tables, so the backward neither
    casts rays nor rebuilds tables; the backward runs K5 and the reduce.
    Gradients for verts_color and faces_opacity; zeros for the other float
    inputs (verts, the four matrices, faces_intense, bg), as the reference
    renderer gives; None for the integer inputs and the settings."""

    @staticmethod
    def forward(ctx, verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                inv_mv_t, inv_proj_t, faces_intense, tets, face_tets,
                tet_faces, bg, height, width, seed, max_steps, kcap,
                view_offset):
        inputs = (verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                  inv_mv_t, inv_proj_t, faces_intense, tets, face_tets,
                  tet_faces, bg)
        color, depth, active, saved = render_tet_forward(
            *inputs, height, width, seed, max_steps, kcap, view_offset)
        ctx.bwd_saved = {k: saved[k] for k in _BWD_SAVED}
        ctx.save_for_backward(faces, face_tets, bg)
        ctx.n_verts = verts.shape[0]
        ctx.zero_like = {i: (inputs[i].shape, inputs[i].device)
                         for i in _ZERO_GRAD_INPUTS}
        aux = (saved["fh_overflow"], saved["fh_num_rendered"])
        ctx.mark_non_differentiable(active, *aux)
        return color, depth, active, *aux

    @staticmethod
    @once_differentiable
    def backward(ctx, dL_dcolor, dL_ddepth, *_nondiff):
        spans.mark("step.loss")
        faces, face_tets, bg = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = [None] * 19
        if need[2] or need[3]:
            g_vc, g_fo = render_tet_backward(ctx.bwd_saved, faces, face_tets,
                                             bg, ctx.n_verts, dL_dcolor,
                                             dL_ddepth)
            grads[2], grads[3] = g_vc, g_fo
        for i, (shape, dev) in ctx.zero_like.items():
            if need[i]:
                grads[i] = torch.zeros(shape, dtype=torch.float32,
                                       device=dev)
        return tuple(grads)


class _EmptyFill(torch.autograd.Function):
    """The image of empty geometry: every pixel the background with depth
    1, inactive. ``bg`` gets the fill's gradient and every other input
    zeros, as ``jax.grad`` gives for inputs the output does not read."""

    @staticmethod
    def forward(ctx, B, height, width, bg, *inputs):
        ctx.like = [(x.shape, x.device) for x in inputs]
        dev = bg.device
        color = bg.reshape(1, 3, 1, 1).expand(B, 3, height, width)
        active = torch.zeros((B, height, width), dtype=torch.bool,
                             device=dev)
        ctx.mark_non_differentiable(active)
        return (color.contiguous(),
                torch.ones((B, 1, height, width), dtype=torch.float32,
                           device=dev), active)

    @staticmethod
    @once_differentiable
    def backward(ctx, dL_dcolor, _dL_ddepth, _dL_dactive):
        return (None, None, None, dL_dcolor.sum(dim=(0, 2, 3))) + tuple(
            torch.zeros(s, dtype=torch.float32, device=d) for s, d in ctx.like)


def render_tet_empty(B: int, height: int, width: int, bg, *inputs):
    """(color, depth, active) of a scene with no vertices, faces or tets,
    differentiable in ``bg`` and, with zero gradients, in ``inputs``."""
    return _EmptyFill.apply(B, height, width, bg, *inputs)


def render_tet_core(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                    inv_mv_t, inv_proj_t, faces_intense, tets, face_tets,
                    tet_faces, bg, height: int, width: int, seed: int,
                    max_steps: int = DEFAULT_MAX_MARCH_STEPS,
                    kcap: int | None = None, with_aux: bool = False,
                    view_offset=None):
    """The tet renderer on transposed matrices with their inverses.

    Shapes: verts [P, 3], faces [F, 3], verts_color [P, 3], faces_opacity
    [F], mv_t/proj_t/inv_mv_t/inv_proj_t [B, 4, 4], faces_intense [B, F],
    tets [T, 4], face_tets [F, 2], tet_faces [T, 4], bg [3]. ``seed`` > 0
    jitters the rays (keyed per global view: ``view_offset`` is the index
    of view 0). Returns (color [B, 3, H, W], depth [B, 1, H, W], active
    [B, H, W] bool) and, with ``with_aux``, ``(overflow, num_rendered)`` of
    the binned first hit (``(False, -1)`` on the dense path).

    Differentiable in verts_color and faces_opacity (zeros for the other
    float inputs) when any input requires grad; otherwise autograd records
    nothing and the forward's residuals are freed on return."""
    color, depth, active, overflow, num_rendered = _RenderTet.apply(
        verts, faces, verts_color, faces_opacity, mv_t, proj_t, inv_mv_t,
        inv_proj_t, faces_intense, tets, face_tets, tet_faces, bg, height,
        width, seed, max_steps, kcap, view_offset)
    if with_aux:
        return color, depth, active, (overflow, num_rendered)
    return color, depth, active
