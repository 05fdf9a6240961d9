"""Per-pixel camera rays of both renderers, in plain torch.

A port of ``generate_rays`` of the JAX package. The ray origin is the camera
position (row 3 of the transposed inverse modelview). The direction points
at the pixel sample unprojected to the NDC z = -1 plane; the unproject drops
the homogeneous w without dividing, as the reference renderer does. The norm
gets +1e-7 in "tri" mode and is clamped at 1e-4 in "tet" mode.

The tet renderer may jitter the pixel samples: with a seed > 0, sample x of
view b is ``x - 0.5 + 0.5 U`` with U drawn as the JAX package draws it,
``uniform(split(fold_in(PRNGKey(seed), view_offset + b))[0], (H, W))`` (and
``[1]`` for y) under JAX's partitionable threefry. ``threefry2x32`` and
``jitter_uniforms`` reproduce those bits in int64 torch arithmetic (uint32
values), on any device.
"""

from __future__ import annotations

import torch

from .geometry import pix2ndc, sqrt_rn, transform_point44

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of key (k0, k1) on the
    counter words (x0, x1). Every argument is an int64 tensor or int holding
    uint32 values; they broadcast. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def jitter_uniforms(seed: int, B: int, height: int, width: int,
                    view_offset: int = 0, device="cpu"):
    """The jitter's U[0, 1) fields, (ux, uy) each [B, H, W] f32: per view
    key ``fold_in(PRNGKey(seed), view_offset + b)``, split in two, and per
    key the f32 uniforms of 32 random bits per pixel (row-major counter)."""
    dev = torch.device(device)
    i64 = dict(dtype=torch.int64, device=dev)
    seed = int(seed)
    k0, k1 = (seed >> 32) & _M32, seed & _M32
    vidx = (torch.arange(B, **i64) + int(view_offset)) & _M32
    f0, f1 = threefry2x32(torch.tensor(k0, **i64), torch.tensor(k1, **i64),
                          torch.zeros_like(vidx), vidx)  # fold_in
    count = torch.arange(height * width, **i64)[None]
    out = []
    for half in (0, 1):  # split: the keys of counters (0, 0) and (0, 1)
        s0, s1 = threefry2x32(f0, f1, 0, half)
        b0, b1 = threefry2x32(s0[:, None], s1[:, None], 0, count)
        bits = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32)
        out.append((bits.view(torch.float32) - 1.0).reshape(B, height, width))
    return out[0], out[1]


def generate_rays(inv_mv_t, inv_proj_t, width: int, height: int, *,
                  norm_eps_mode: str = "tri", jitter_seed: int | None = None,
                  view_offset: int | None = None):
    """Rays for every view: inv_mv_t, inv_proj_t [B, 4, 4] (transposed).

    ``norm_eps_mode``: "tri" (norm + 1e-7) or "tet" (norm clamped at 1e-4).
    ``jitter_seed``: a positive int jitters the samples (see the module
    docstring); ``view_offset`` is the global index of view 0 (default 0).
    Returns (ray_o [B, H, W, 3], ray_d [B, H, W, 3])."""
    if norm_eps_mode not in ("tri", "tet"):
        raise ValueError(f"unknown norm_eps_mode: {norm_eps_mode}")
    B = inv_mv_t.shape[0]
    dev = inv_mv_t.device
    ray_o = inv_mv_t[:, 3, :3]  # [B, 3]

    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    pix_y, pix_x = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]
    if jitter_seed is not None and jitter_seed > 0:
        ux, uy = jitter_uniforms(jitter_seed, B, height, width,
                                 view_offset or 0, dev)
        pixf_x = pix_x[None] - 0.5 + 0.5 * ux
        pixf_y = pix_y[None] - 0.5 + 0.5 * uy
    else:
        pixf_x = (pix_x + 0.5).expand(B, height, width)
        pixf_y = (pix_y + 0.5).expand(B, height, width)
    ndc_x = pix2ndc(pixf_x, width)
    ndc_y = pix2ndc(pixf_y, height)
    ndc = torch.stack([ndc_x, ndc_y, torch.full_like(ndc_x, -1.0)], dim=-1)

    pix_view = transform_point44(ndc, inv_proj_t[:, None, None, :, :])[..., :3]
    pix_world = transform_point44(
        pix_view, inv_mv_t[:, None, None, :, :])[..., :3]

    d = pix_world - ray_o[:, None, None, :]
    # the correctly rounded root (sqrt_rn): the rays must not depend on the
    # device or the process
    sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    norm = sqrt_rn(sq)
    if norm_eps_mode == "tri":
        norm = norm + 1e-7
    else:
        norm = torch.maximum(norm, torch.full_like(norm, 1e-4))
    ray_d = d / norm[..., None]
    return ray_o[:, None, None, :].expand(ray_d.shape), ray_d
