"""Public API of the tri renderer (forward), in PyTorch.

The same symbols, signatures, dtype casts and matrix transposes as the tri
half of the JAX package's ``api.py``: ``TriRenderSettings``, ``render_tri``
(matrices already transposed) and ``TriRenderer`` (casts ``faces`` to int32
and transposes the modelview/projection matrices). Inputs may be torch
tensors or NumPy arrays; outputs are torch tensors on ``device``.

Entry points run on ``device="cuda"`` unless the caller passes another
device; asking for CUDA where there is no card raises. Gradients are not
part of this port yet: a differentiable input with ``requires_grad=True``
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

_GRAD_MSG = (
    "gradients of the tri renderer are not ported yet: the backward lands "
    "with the port of dmesh_renderer_tpu/ops/tri_binned.py::_bwd_kernel; "
    "pass tensors that do not require grad (or detach them)")


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def _as_tensor(x: Any, dtype, device, differentiable=False) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if differentiable and x.requires_grad:
            raise NotImplementedError(_GRAD_MSG)
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=device).contiguous()


class TriRenderSettings(NamedTuple):
    """Image size and background, plus the binned path's static capacities
    (``key_capacity``: (face, tile) pairs; ``run_capacity``: (face,
    tile-row) runs; None picks heuristics; size them with
    ``ops.binning.recommended_key_capacity``/``recommended_run_capacity``).
    """
    image_height: int
    image_width: int
    bg: Any  # [3] background colour
    key_capacity: Any = None
    run_capacity: Any = None


def render_tri(verts, faces, verts_color, faces_opacity, mv_mats, proj_mats,
               verts_depth, faces_intense, render_settings: TriRenderSettings,
               return_aux: bool = False, device="cuda"):
    """Functional tri renderer; expects transposed matrices.

    Returns (color [B, 3, H, W], depth [B, 1, H, W]) and, with
    ``return_aux``, ``(overflow, num_rendered)``: whether the binned path's
    key capacity dropped pairs, and how many (face, tile) pairs it emitted
    (``(False, -1)`` on the dense path)."""
    from .ops.tri import render_tri_auto
    from .validation import check_tri_inputs

    dev = resolve_device(device)
    f32 = torch.float32
    mv_t = _as_tensor(mv_mats, f32, dev)
    proj_t = _as_tensor(proj_mats, f32, dev)
    args = (
        _as_tensor(verts, f32, dev, True),
        _as_tensor(faces, torch.int32, dev),
        _as_tensor(verts_color, f32, dev, True),
        _as_tensor(faces_opacity, f32, dev, True),
        mv_t,
        proj_t,
        _as_tensor(verts_depth, f32, dev, True),
        _as_tensor(faces_intense, f32, dev, True),
        _as_tensor(render_settings.bg, f32, dev),
    )
    check_tri_inputs(*args)
    inv_mv_t = torch.linalg.inv(mv_t)
    inv_proj_t = torch.linalg.inv(proj_t)
    kcap = render_settings.key_capacity
    rcap = render_settings.run_capacity
    return render_tri_auto(
        args[0], args[1], args[2], args[3], mv_t, proj_t, inv_mv_t,
        inv_proj_t, args[6], args[7], args[8],
        int(render_settings.image_height), int(render_settings.image_width),
        kcap=None if kcap is None else int(kcap),
        with_aux=return_aux,
        run_cap=None if rcap is None else int(rcap))


class TriRenderer(nn.Module):
    """Module form: casts ``faces`` to int32 and transposes the row-major
    modelview/projection matrices [B, 4, 4] before ``render_tri``."""

    def __init__(self, render_settings: TriRenderSettings, device="cuda"):
        super().__init__()
        self.render_settings = render_settings
        self.device = resolve_device(device)

    def forward(self, verts, faces, verts_color, faces_opacity, mv_mats,
                proj_mats, verts_depth, faces_intense,
                return_aux: bool = False):
        mv = _as_tensor(mv_mats, torch.float32, self.device)
        proj = _as_tensor(proj_mats, torch.float32, self.device)
        return render_tri(
            verts, _as_tensor(faces, torch.int32, self.device), verts_color,
            faces_opacity, mv.transpose(1, 2), proj.transpose(1, 2),
            verts_depth, faces_intense, self.render_settings,
            return_aux=return_aux, device=self.device)
