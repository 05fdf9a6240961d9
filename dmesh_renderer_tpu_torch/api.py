"""Public API of both renderers, in PyTorch.

The same symbols, signatures, dtype casts and matrix transposes as the JAX
package's ``api.py``: ``TriRenderSettings``, ``render_tri`` (matrices
already transposed) and ``TriRenderer`` (casts ``faces`` to int32 and
transposes the modelview/projection matrices), and their tet counterparts
``TetRenderSettings``, ``render_tet`` and ``TetRenderer``. Inputs may be
torch tensors or NumPy arrays; outputs are torch tensors on ``device``.

Entry points run on ``device="cuda"`` unless the caller passes another
device; asking for CUDA where there is no card raises. Tri gradients flow
to ``verts``, ``verts_color``, ``faces_opacity``, ``verts_depth`` and
``faces_intense`` (through the casts to float32 and to ``device``); faces,
the matrices and ``bg`` get none, as in the reference renderer. Tet
gradients flow to ``verts_color`` and ``faces_opacity``; the other float
inputs that require grad get zeros, as in the reference renderer.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def _as_tensor(x: Any, dtype, device) -> torch.Tensor:
    """``x`` as a contiguous tensor of ``dtype`` on ``device``; a tensor's
    casts are recorded by autograd, so gradients reach the caller's tensor."""
    if isinstance(x, torch.Tensor):
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


def _inverses(mv_t, proj_t):
    """The inverses of the [B, 4, 4] modelview and projection matrices on
    their own device (``ops.geometry.inverse44``: the same bits on the CPU
    and on the card, no host sync)."""
    from .ops.geometry import inverse44

    both = inverse44(torch.stack([mv_t, proj_t]))
    return both[0], both[1]


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
        _as_tensor(verts, f32, dev),
        _as_tensor(faces, torch.int32, dev),
        _as_tensor(verts_color, f32, dev),
        _as_tensor(faces_opacity, f32, dev),
        mv_t,
        proj_t,
        _as_tensor(verts_depth, f32, dev),
        _as_tensor(faces_intense, f32, dev),
        _as_tensor(render_settings.bg, f32, dev),
    )
    check_tri_inputs(*args)
    inv_mv_t, inv_proj_t = _inverses(mv_t, proj_t)
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


class TetRenderSettings(NamedTuple):
    """Image size and background; ``ray_random_seed`` > 0 jitters the
    rays; ``key_capacity`` is the binned first hit's static (face, tile)
    pair capacity (None picks a heuristic)."""
    image_height: int
    image_width: int
    bg: Any
    ray_random_seed: int = 0
    key_capacity: Any = None


def render_tet(verts, faces, verts_color, faces_opacity, mv_mats, proj_mats,
               verts_depth, faces_intense, tets, face_tets, tet_faces,
               render_settings: TetRenderSettings, return_aux: bool = False,
               device="cuda"):
    """Functional tet renderer; expects transposed matrices.

    Returns (color [B, 3, H, W], depth [B, 1, H, W], active [B, H, W] bool)
    and, with ``return_aux``, ``(overflow, num_rendered)`` of the binned
    first hit (``(False, -1)`` on the dense path). ``verts_depth`` is
    accepted and unused. With no vertices, faces or tets every pixel is
    background with depth 1, inactive, and the aux is ``(False, 0)``; then
    ``bg`` gets the fill's gradient and the other float inputs zeros."""
    from .ops.tet import render_tet_core, render_tet_empty
    from .validation import check_tet_inputs

    dev = resolve_device(device)
    f32, i32 = torch.float32, torch.int32
    mv_t = _as_tensor(mv_mats, f32, dev)
    proj_t = _as_tensor(proj_mats, f32, dev)
    a = dict(
        verts=_as_tensor(verts, f32, dev),
        faces=_as_tensor(faces, i32, dev),
        verts_color=_as_tensor(verts_color, f32, dev),
        faces_opacity=_as_tensor(faces_opacity, f32, dev),
        faces_intense=_as_tensor(faces_intense, f32, dev),
        tets=_as_tensor(tets, i32, dev),
        face_tets=_as_tensor(face_tets, i32, dev),
        tet_faces=_as_tensor(tet_faces, i32, dev),
        bg=_as_tensor(render_settings.bg, f32, dev),
    )
    check_tet_inputs(a["verts"], a["faces"], a["verts_color"],
                     a["faces_opacity"], mv_t, proj_t, a["faces_intense"],
                     a["tets"], a["face_tets"], a["tet_faces"], a["bg"])
    B = mv_t.shape[0]
    H = int(render_settings.image_height)
    W = int(render_settings.image_width)
    if (a["verts"].shape[0] == 0 or a["faces"].shape[0] == 0
            or a["tets"].shape[0] == 0):
        # no geometry: no ray finds a first hit, so every pixel takes the
        # inactive fill
        color, depth, active = render_tet_empty(
            B, H, W, a["bg"], a["verts"], a["verts_color"],
            a["faces_opacity"], mv_t, proj_t, a["faces_intense"])
        if return_aux:
            return color, depth, active, (torch.tensor(False, device=dev),
                                          torch.tensor(0, device=dev))
        return color, depth, active

    kcap = render_settings.key_capacity
    return render_tet_core(
        a["verts"], a["faces"], a["verts_color"], a["faces_opacity"], mv_t,
        proj_t, *_inverses(mv_t, proj_t),
        a["faces_intense"], a["tets"], a["face_tets"], a["tet_faces"],
        a["bg"], H, W, int(render_settings.ray_random_seed),
        kcap=None if kcap is None else int(kcap), with_aux=return_aux)


class TetRenderer(nn.Module):
    """Module form: casts the index arrays to int32 and transposes the
    row-major modelview/projection matrices [B, 4, 4] before
    ``render_tet``."""

    def __init__(self, render_settings: TetRenderSettings, device="cuda"):
        super().__init__()
        self.render_settings = render_settings
        self.device = resolve_device(device)

    def forward(self, verts, faces, verts_color, faces_opacity, mv_mats,
                proj_mats, verts_depth, faces_intense, tets, face_tets,
                tet_faces, return_aux: bool = False):
        i32 = torch.int32
        mv = _as_tensor(mv_mats, torch.float32, self.device)
        proj = _as_tensor(proj_mats, torch.float32, self.device)
        return render_tet(
            verts, _as_tensor(faces, i32, self.device), verts_color,
            faces_opacity, mv.transpose(1, 2), proj.transpose(1, 2),
            verts_depth, faces_intense, _as_tensor(tets, i32, self.device),
            _as_tensor(face_tets, i32, self.device),
            _as_tensor(tet_faces, i32, self.device), self.render_settings,
            return_aux=return_aux, device=self.device)
