"""The renderers' geometry arithmetic, frozen for the benchmark's reference.

A copy of the plain-torch arithmetic the renderers are specified by
(projection, the fixed-point coverage test with the top-left rule and
wrapped int32 edge functions, Moller-Trumbore, the barycentric clamp, the
reference renderer's (u, v) gradients, the per-face culling and tile rects,
the closed-form 4x4 inverse and the correctly rounded square root). It is
kept here, and not imported, so that a later change to the program cannot
move the yardstick. Every product and sum is an elementwise f32 op in a
fixed order: coverage and culling are integer decisions taken from f32
values, and a different summation order would move them.
"""

from __future__ import annotations

import math

import torch

SUBPIXEL = 16.0  # fixed-point subpixels per pixel of the coverage test
W_EPS = 1e-4     # clamp of the perspective divide's denominator
T_EPS = 1e-4     # transmittance below which a pixel stops blending
BIN_TILE = 32    # coverage-rect granularity of every tri path, in pixels

_I32_MIN = -(2 ** 31)
_I32_MAX = 2 ** 31 - 1
_F32_BELOW_2_31 = 2147483520.0  # largest f32 below 2^31
_INV44_CACHE: dict = {}


def sat_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 like XLA's convert: truncate toward zero, saturate out
    of range, NaN -> 0. The same result on every device."""
    y = torch.nan_to_num(x, nan=0.0).clamp(float(_I32_MIN), _F32_BELOW_2_31)
    y = y.to(torch.int32)
    return torch.where(x >= 2147483648.0, torch.full_like(y, _I32_MAX), y)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of an f32 tensor, the same bits
    on every device. torch's CPU square roots are not correctly rounded (the
    f32 one is a vector-math routine, and even the f64 one, rounded to f32,
    differs from the correct root on some inputs and from one process to
    the next), while CUDA's are. So the f64 root rounded to f32 is only a
    first guess r; of r and its two f32 neighbours the one nearest the true
    root is kept, decided exactly in f64: the midpoints between neighbours
    have 25 significant bits, so their squares are exact."""
    xd = x.double()
    r = torch.sqrt(xd).float()
    lo = torch.nextafter(r, torch.zeros_like(r))
    hi = torch.nextafter(r, torch.full_like(r, math.inf))
    rd = r.double()
    m_lo = (lo.double() + rd) * 0.5
    m_hi = (rd + hi.double()) * 0.5
    r = torch.where(xd < m_lo * m_lo, lo,
                    torch.where(xd > m_hi * m_hi, hi, r))
    # zero, negative, inf and NaN inputs: the root is exact or NaN anyway
    return torch.where(torch.isfinite(x) & (x > 0), r, torch.sqrt(x))


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Wrap int64 values to the int32 range modulo 2^32 (stays int64)."""
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def transform_point44(p: torch.Tensor, m_t: torch.Tensor) -> torch.Tensor:
    """[..., 3] points by a transposed [..., 4, 4] matrix -> [..., 4]."""
    return (
        p[..., 0:1] * m_t[..., 0, :]
        + p[..., 1:2] * m_t[..., 1, :]
        + p[..., 2:3] * m_t[..., 2, :]
        + m_t[..., 3, :]
    )


def _inverse44_tables():
    """Index and sign tables of the closed-form 4x4 inverse over a matrix
    flattened row-major (``x[4 * row + col]``).

    ``MINOR_*``: the twelve 2x2 minors of rows (0, 1) and rows (2, 3) over
    each column pair, ``x[A] * x[B] - x[C] * x[D]``. ``TERM_*``: the adjugate
    entry ``adj[j][i]`` = cofactor ``C[i][j]`` is the 3x3 minor without row
    ``i`` and column ``j``, expanded along the row of ``i``'s half that
    remains: three terms ``sign * x[row, col] * minor`` of the other half."""
    pairs = [(p, q) for p in range(4) for q in range(p + 1, 4)]
    ma, mb, mc, md = [], [], [], []
    for r0, r1 in ((0, 1), (2, 3)):
        for p, q in pairs:
            ma.append(4 * r0 + p)
            mb.append(4 * r1 + q)
            mc.append(4 * r1 + p)
            md.append(4 * r0 + q)
    tx, tm, ts = [[0] * 3 for _ in range(16)], [[0] * 3 for _ in range(16)], \
        [[0.0] * 3 for _ in range(16)]
    for i in range(4):
        row, other = (1 - i, 6) if i < 2 else (5 - i, 0)
        for j in range(4):
            cols = [c for c in range(4) if c != j]
            e = 4 * j + i
            for t in range(3):
                rest = tuple(c for c in cols if c != cols[t])
                tx[e][t] = 4 * row + cols[t]
                tm[e][t] = other + pairs.index(rest)
                ts[e][t] = float((-1) ** (i + j + t))
    return (ma, mb, mc, md), (tx, tm, ts)


_INV44_MINORS, _INV44_TERMS = _inverse44_tables()


def inverse44(m: torch.Tensor) -> torch.Tensor:
    """Inverses of [..., 4, 4] f32 matrices on their own device, bit-equal
    on the CPU and on the card.

    The adjugate over the 2x2 minors, divided by the determinant, in f64
    and rounded to f32 once. Only gathers, elementwise products and sums in
    a fixed order and one quotient, each rounded by IEEE rules on every
    device; a solver's (LAPACK's against cuSOLVER's) parts in the last bit,
    and along a long tet walk such a difference grows past 1e-5 in a
    pixel's colour. No host sync."""
    dev = m.device
    if dev not in _INV44_CACHE:
        def idx(v):
            return torch.tensor(v, dtype=torch.long, device=dev)
        _INV44_CACHE[dev] = (
            [idx(v) for v in _INV44_MINORS],
            [idx(v) for v in _INV44_TERMS[:2]],
            torch.tensor(_INV44_TERMS[2], dtype=torch.float64, device=dev))
    (ma, mb, mc, md), (tx, tm), ts = _INV44_CACHE[dev]
    x = m.reshape(*m.shape[:-2], 16).double()
    minors = x[..., ma] * x[..., mb] - x[..., mc] * x[..., md]
    t = (ts * x[..., tx]) * minors[..., tm]
    adj = (t[..., 0] + t[..., 1]) + t[..., 2]
    # the cofactor expansion along row 0: sum_k x[0, k] * adj[k][0]
    det = (((x[..., 0] * adj[..., 0] + x[..., 1] * adj[..., 4])
            + x[..., 2] * adj[..., 8]) + x[..., 3] * adj[..., 12])
    return (adj / det[..., None]).float().reshape(m.shape)


def transform_point43(p: torch.Tensor, m_t: torch.Tensor) -> torch.Tensor:
    """Affine transform (drops the homogeneous w of the result)."""
    return transform_point44(p, m_t)[..., :3]


def ndc2pix(v: torch.Tensor, size) -> torch.Tensor:
    """NDC coordinate -> continuous pixel coordinate, rounded in f32."""
    return ((v + 1.0) * size - 1.0) * 0.5


def pix2ndc(v: torch.Tensor, size) -> torch.Tensor:
    """Continuous pixel coordinate -> NDC, rounded in f32.

    The divisor is a tensor: CUDA divides by a Python scalar as a multiply
    by its reciprocal, which rounds differently from the CPU's division."""
    return ((v * 2.0 + 1.0) / torch.full_like(v, size)) - 1.0


def clamp_w(w: torch.Tensor, eps: float = W_EPS) -> torch.Tensor:
    """Guard the perspective-divide denominator away from zero."""
    pos = torch.full_like(w, eps)
    return torch.where(
        (w >= 0) & (w < eps), pos,
        torch.where((w < 0) & (w > -eps), -pos, w))


def project_verts(verts, mv_t, proj_t, width: int, height: int):
    """Project [P, 3] vertices through [B, 4, 4] transposed matrices.

    Returns (verts_ndc [B, P, 3], verts_image [B, P, 2])."""
    v = verts[None, :, :]
    p_view = transform_point43(v, mv_t[:, None, :, :])
    p_proj = transform_point44(p_view, proj_t[:, None, :, :])
    inv_w = torch.reciprocal(clamp_w(p_proj[..., 3]))
    ndc = p_proj[..., :3] * inv_w[..., None]
    image = torch.stack(
        [ndc2pix(ndc[..., 0], width), ndc2pix(ndc[..., 1], height)], dim=-1)
    return ndc, image


def _fixed(a: torch.Tensor) -> torch.Tensor:
    """Continuous coordinate -> 16x-subpixel fixed point (int64 holding an
    int32 value; C truncation toward zero, saturating)."""
    return sat_i32(a * SUBPIXEL).long()


def _edge(xa, ya, xb, yb):
    """Coefficients (A, B, C) of one edge function A*px + B*py + C, with the
    top-left bias folded into C, all wrapped int32 values in int64."""
    cx = wrap_i32(xa - xb)
    cy = wrap_i32(ya - yb)
    bias = ((cy > 0) | ((cy == 0) & (cx > 0))).long()
    c = wrap_i32(wrap_i32(cy * xa) - wrap_i32(cx * ya) - bias)
    return wrap_i32(-cy), cx, c


def _ccw(x1, y1, x2, y2, x3, y3):
    """Signed area and the CCW-normalised vertices 2 and 3."""
    area = wrap_i32(wrap_i32(wrap_i32(x2 - x1) * wrap_i32(y3 - y1))
                    - wrap_i32(wrap_i32(x3 - x1) * wrap_i32(y2 - y1)))
    neg = area < 0
    x2s = torch.where(neg, x3, x2)
    y2s = torch.where(neg, y3, y2)
    x3s = torch.where(neg, x2, x3)
    y3s = torch.where(neg, y2, y3)
    return area, x2s, y2s, x3s, y3s


def edge_value(a, b, c, px, py) -> torch.Tensor:
    """Wrapped int32 edge function A*px + B*py + C (int64 in, int64 out)."""
    return wrap_i32(wrap_i32(a * px) + wrap_i32(b * py) + c)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, elementwise."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over a last axis of 3, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def ray_tri_intersection(ray_o, ray_d, p0, p1, p2):
    """Permissive Moller-Trumbore, batched over broadcast leading dims.

    Returns (tuv [..., 3], nondegenerate [...]); only rays parallel to the
    triangle plane are degenerate. Out-of-triangle (u, v) are left for
    ``clamp_bary_uv``."""
    t_vec = ray_o - p0
    e1 = p1 - p0
    e2 = p2 - p0
    pv = cross(ray_d, e2)
    qv = cross(t_vec, e1)
    denom = dot3(pv, e1)
    nondegenerate = denom != 0.0
    inv = torch.reciprocal(
        torch.where(nondegenerate, denom, torch.ones_like(denom)))
    t = dot3(qv, e2) * inv
    u = dot3(pv, t_vec) * inv
    v = dot3(qv, ray_d) * inv
    return torch.stack([t, u, v], dim=-1), nondegenerate


def clamp_bary_uv(u: torch.Tensor, v: torch.Tensor):
    """Project (u, v) into {u>=0, v>=0, u+v<=1}; returns (u_c, v_c, code)
    with the reference's 7 region codes, first matching branch wins."""
    c0 = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    c1 = (u <= 0.0) & (v <= 0.0)
    c2 = ((u >= 1.0) & (v <= 0.0)) | ((v >= 0.0) & (v <= u - 1.0))
    c3 = ((u <= 0.0) & (v >= 1.0)) | ((u >= 0.0) & (v >= u + 1.0))
    c4 = (u <= 0.0) & (v <= 1.0) & (v >= 0.0)
    c5 = (u <= 1.0) & (u >= 0.0) & (v <= 0.0)

    zero = torch.zeros_like(u)
    one = torch.ones_like(u)
    u6 = (1.0 + u - v) * 0.5
    v6 = (1.0 - u + v) * 0.5
    w = torch.where
    u_c = w(c0, u, w(c1, zero, w(c2, one, w(c3, zero, w(c4, zero,
                                                       w(c5, u, u6))))))
    v_c = w(c0, v, w(c1, zero, w(c2, zero, w(c3, one, w(c4, v,
                                                       w(c5, zero, v6))))))
    code = torch.full(u.shape, 6, dtype=torch.int32, device=u.device)
    for k, cond in reversed(list(enumerate((c0, c1, c2, c3, c4, c5)))):
        code = torch.where(cond, torch.full_like(code, k), code)
    return u_c, v_c, code


def ray_tri_uv_grads_reference(ray_o, ray_d, p0, p1, p2):
    """The reference renderer's analytic (u, v) gradients w.r.t. the vertex
    positions: (du_dp0, du_dp1, du_dp2, dv_dp0, dv_dp1, dv_dp2), each
    [..., 3].

    The "dv" formulas are, as in the reference, the quotient-rule gradient
    of the ray parameter t, not of the barycentric v: ``v2 = (T x E1) . E2``
    is the numerator of t, where the forward's v uses ``(T x E1) . d``. The
    backward chains dL/dv through them, so this keeps them. A zero
    denominator is replaced by 1 (those lanes are masked by the callers)."""
    t_vec = ray_o - p0
    e1 = p1 - p0
    e2 = p2 - p0

    rd_x_e2 = cross(ray_d, e2)
    denom_sqrt = dot3(rd_x_e2, e1)
    denom = denom_sqrt * denom_sqrt
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    inv = torch.reciprocal(denom)[..., None]

    v0 = dot3(rd_x_e2, t_vec)[..., None]  # u numerator
    v1 = denom_sqrt[..., None]
    v2 = dot3(cross(t_vec, e1), e2)[..., None]  # t numerator

    t_x_rd = cross(t_vec, ray_d)
    e1_x_rd = cross(e1, ray_d)

    du_de1 = -rd_x_e2 * v0 * inv
    du_de2 = (t_x_rd * v1 - v0 * e1_x_rd) * inv
    du_dt = rd_x_e2 * v1 * inv

    dv_de1 = (cross(e2, t_vec) * v1 - v2 * rd_x_e2) * inv
    dv_de2 = (cross(t_vec, e1) * v1 - v2 * e1_x_rd) * inv
    dv_dt = cross(e1, e2) * v1 * inv

    du_dp0 = -du_de1 - du_de2 - du_dt
    dv_dp0 = -dv_de1 - dv_de2 - dv_dt
    return du_dp0, du_de1, du_de2, dv_dp0, dv_de1, dv_de2


def face_edge_coeffs(verts_image, faces, fimg=None):
    """Fixed-point coverage edge coefficients per (view, face).

    Returns (A, B, C, nondeg): A/B/C are length-3 tuples of [B, F] int32
    tensors such that the pixel sample (px, py) is covered iff the wrapped
    int32 value A_e*px + B_e*py + C_e < 0 for all three edges (top-left bias
    in C, winding normalised CCW as ``in_tri`` does).

    ``fimg``: optional pre-gathered [B, F, 3, 2] per-face image coords."""
    im = verts_image[:, faces.long(), :] if fimg is None else fimg
    xi = _fixed(im[..., 0])
    yi = _fixed(im[..., 1])
    x1, x2, x3 = xi[..., 0], xi[..., 1], xi[..., 2]
    y1, y2, y3 = yi[..., 0], yi[..., 1], yi[..., 2]
    area, x2s, y2s, x3s, y3s = _ccw(x1, y1, x2, y2, x3, y3)
    e1 = _edge(x1, y1, x2s, y2s)
    e2 = _edge(x2s, y2s, x3s, y3s)
    e3 = _edge(x3s, y3s, x1, y1)
    i32 = lambda t: t.to(torch.int32)
    return (tuple(i32(e[0]) for e in (e1, e2, e3)),
            tuple(i32(e[1]) for e in (e1, e2, e3)),
            tuple(i32(e[2]) for e in (e1, e2, e3)),
            area != 0)


def preprocess_faces(verts_ndc, verts_image, faces, width: int, height: int,
                     tile_x: int, tile_y: int) -> dict:
    """Per-(view, face) culling, depth keys and tile-space bounding rects.

    verts_ndc [B, P, 3]; verts_image [B, P, 2]; faces [F, 3] integer.
    Returns a dict of [B, F] tensors: ``depth``, ``min_depth``,
    ``max_depth`` (mean/min/max NDC z remapped to [0, 1], clamped),
    ``rect_min``/``rect_max`` [B, F, 2] int32 tile ranges [min, max),
    ``tiles`` (touched tiles, 0 if culled), ``valid``, and the coverage edge
    coefficients ``edge_a``/``edge_b``/``edge_c`` (3-tuples) and
    ``nondeg``."""
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = (height + tile_y - 1) // tile_y
    B = verts_ndc.shape[0]
    F = faces.shape[0]
    pv = torch.cat([verts_ndc[..., 2:3], verts_image], dim=-1)
    g = pv[:, faces.reshape(-1).long(), :].reshape(B, F, 3, 3)
    fz = g[..., 0]
    fimg = g[..., 1:3]

    max_z = fz.amax(dim=-1)
    min_z = fz.amin(dim=-1)
    # the mean as XLA computes it: a left-to-right sum times f32(1/3)
    mean_z = (fz[..., 0] + fz[..., 1] + fz[..., 2]) * (1.0 / 3.0)

    def remap01(z):
        return ((z + 1.0) * 0.5).clamp(0.0, 1.0)

    # tile rect: C truncation toward zero (saturating), then clamp to the
    # grid; the +1 wraps in int32 as in JAX before the clamp
    xs = fimg[..., 0]
    ys = fimg[..., 1]

    def lo(v, t, n):
        return sat_i32(v.amin(dim=-1) / t).clamp(0, n)

    def hi(v, t, n):
        return wrap_i32(sat_i32(v.amax(dim=-1) / t).long() + 1).clamp(
            0, n).to(torch.int32)

    rect_min_x, rect_min_y = lo(xs, tile_x, grid_x), lo(ys, tile_y, grid_y)
    rect_max_x, rect_max_y = hi(xs, tile_x, grid_x), hi(ys, tile_y, grid_y)

    tiles = (rect_max_x - rect_min_x) * (rect_max_y - rect_min_y)
    z_ok = ~((max_z < -1.0) | (min_z > 1.0))
    valid = z_ok & (tiles > 0)
    tiles = torch.where(valid, tiles, torch.zeros_like(tiles))

    eA, eB, eC, nondeg = face_edge_coeffs(verts_image, faces, fimg=fimg)
    return {
        "depth": remap01(mean_z),
        "min_depth": remap01(min_z),
        "max_depth": remap01(max_z),
        "rect_min": torch.stack([rect_min_x, rect_min_y], dim=-1),
        "rect_max": torch.stack([rect_max_x, rect_max_y], dim=-1),
        "tiles": tiles,
        "valid": valid,
        "edge_a": eA,
        "edge_b": eB,
        "edge_c": eC,
        "nondeg": nondeg,
    }


def generate_rays(inv_mv_t, inv_proj_t, width: int, height: int,
                  mode: str = "tri"):
    """Rays through every pixel centre, [B, H, W, 3] origin and direction:
    the camera position, and the pixel sample unprojected to the NDC z = -1
    plane (w dropped without a divide), normalised with +1e-7 ("tri") or a
    norm clamped at 1e-4 ("tet")."""
    B = inv_mv_t.shape[0]
    dev = inv_mv_t.device
    ray_o = inv_mv_t[:, 3, :3]
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    pix_y, pix_x = torch.meshgrid(ys, xs, indexing="ij")
    ndc_x = pix2ndc((pix_x + 0.5).expand(B, height, width), width)
    ndc_y = pix2ndc((pix_y + 0.5).expand(B, height, width), height)
    ndc = torch.stack([ndc_x, ndc_y, torch.full_like(ndc_x, -1.0)], dim=-1)
    pix_view = transform_point44(ndc, inv_proj_t[:, None, None])[..., :3]
    pix_world = transform_point44(pix_view, inv_mv_t[:, None, None])[..., :3]
    d = pix_world - ray_o[:, None, None, :]
    sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    norm = sqrt_rn(sq)
    if mode == "tri":
        norm = norm + 1e-7
    else:
        norm = torch.maximum(norm, torch.full_like(norm, 1e-4))
    ray_d = d / norm[..., None]
    return ray_o[:, None, None, :].expand(ray_d.shape), ray_d
