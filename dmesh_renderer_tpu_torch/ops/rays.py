"""Per-pixel camera rays of the tri renderer, in plain torch.

A port of ``generate_rays`` of the JAX package in its "tri" mode without
jitter. The ray origin is the camera position (row 3 of the transposed
inverse modelview). The direction points at the pixel centre unprojected to
the NDC z = -1 plane; the unproject drops the homogeneous w without dividing,
and the norm gets +1e-7, both as the reference renderer does.
"""

from __future__ import annotations

import torch

from .geometry import pix2ndc, transform_point44


def generate_rays(inv_mv_t, inv_proj_t, width: int, height: int):
    """Rays for every view: inv_mv_t, inv_proj_t [B, 4, 4] (transposed).

    Returns (ray_o [B, H, W, 3], ray_d [B, H, W, 3])."""
    B = inv_mv_t.shape[0]
    dev = inv_mv_t.device
    ray_o = inv_mv_t[:, 3, :3]  # [B, 3]

    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    pix_y, pix_x = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]
    ndc_x = pix2ndc(pix_x + 0.5, width).expand(B, height, width)
    ndc_y = pix2ndc(pix_y + 0.5, height).expand(B, height, width)
    ndc = torch.stack([ndc_x, ndc_y, torch.full_like(ndc_x, -1.0)], dim=-1)

    pix_view = transform_point44(ndc, inv_proj_t[:, None, None, :, :])[..., :3]
    pix_world = transform_point44(
        pix_view, inv_mv_t[:, None, None, :, :])[..., :3]

    d = pix_world - ray_o[:, None, None, :]
    norm = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2]) + 1e-7
    ray_d = d / norm[..., None]
    return ray_o[:, None, None, :].expand(ray_d.shape), ray_d
