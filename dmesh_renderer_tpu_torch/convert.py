"""Carry the JAX functional call's arrays into the port's tensors and back.

``tri_inputs_from_numpy`` takes the eleven arrays of the JAX package's
functional tri call (``render_tri_auto`` / ``render_tri_binned`` /
``render_tri_oracle`` order, matrices transposed, inverse matrices given)
and returns the port's tensors holding the same bits, so that both packages
can be fed identical inputs, inverse matrices included;
``tet_args_from_numpy`` does the same for the tet call.
``tri_scene_from_numpy`` and ``view_batch_from_numpy`` do the same for the
train step's ``TriScene`` and ``ViewBatch`` (models/dmesh.py), and
``tet_scene_from_numpy`` and ``tet_view_batch_from_numpy`` for the tet train
step's ``TetScene`` and ``TetViewBatch``.
"""

from __future__ import annotations

import numpy as np
import torch


def tri_inputs_from_numpy(verts, faces, verts_color, faces_opacity, mv_t,
                          proj_t, inv_mv_t, inv_proj_t, verts_depth,
                          faces_intense, bg, device="cuda"):
    """Arrays (anything ``np.asarray`` takes) -> tensors on ``device``:
    f32 everywhere, int32 ``faces``."""
    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return (f32(verts),
            torch.from_numpy(np.array(faces, dtype=np.int32)).to(device),
            f32(verts_color), f32(faces_opacity), f32(mv_t), f32(proj_t),
            f32(inv_mv_t), f32(inv_proj_t), f32(verts_depth),
            f32(faces_intense), f32(bg))


def tet_args_from_numpy(verts, faces, verts_color, faces_opacity, mv_t,
                        proj_t, inv_mv_t, inv_proj_t, faces_intense, tets,
                        face_tets, tet_faces, bg, device="cuda"):
    """The thirteen arrays of the JAX package's functional tet call
    (``render_tet_core`` order, matrices transposed, inverse matrices given)
    -> tensors on ``device``: int32 ``faces``, ``tets``, ``face_tets`` and
    ``tet_faces``, f32 everything else."""
    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def i32(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

    return (f32(verts), i32(faces), f32(verts_color), f32(faces_opacity),
            f32(mv_t), f32(proj_t), f32(inv_mv_t), f32(inv_proj_t),
            f32(faces_intense), i32(tets), i32(face_tets), i32(tet_faces),
            f32(bg))


def tri_scene_from_numpy(verts, verts_color, faces_opacity, device="cuda"):
    """The JAX package's ``TriScene`` arrays -> the port's ``TriScene`` of
    f32 leaf tensors on ``device`` that require grad. Optimiser state
    starts at zero in both packages, so carrying the scene is enough for
    both to take the same steps."""
    from .models.dmesh import TriScene

    return TriScene(*(torch.from_numpy(np.array(a, dtype=np.float32))
                      .to(device).requires_grad_(True)
                      for a in (verts, verts_color, faces_opacity)))


def view_batch_from_numpy(mv_t, proj_t, inv_mv_t, inv_proj_t, verts_depth,
                          faces_intense, target, device="cuda"):
    """The JAX package's ``ViewBatch`` arrays -> the port's ``ViewBatch`` of
    f32 tensors on ``device``."""
    from .models.dmesh import ViewBatch

    return ViewBatch(*(torch.from_numpy(np.array(a, dtype=np.float32))
                       .to(device)
                       for a in (mv_t, proj_t, inv_mv_t, inv_proj_t,
                                 verts_depth, faces_intense, target)))


def tet_scene_from_numpy(verts_color, faces_opacity, device="cuda"):
    """The JAX package's ``TetScene`` arrays -> the port's ``TetScene`` of
    f32 leaf tensors on ``device`` that require grad."""
    from .models.dmesh import TetScene

    return TetScene(*(torch.from_numpy(np.array(a, dtype=np.float32))
                      .to(device).requires_grad_(True)
                      for a in (verts_color, faces_opacity)))


def tet_view_batch_from_numpy(mv_t, proj_t, inv_mv_t, inv_proj_t,
                              faces_intense, target, device="cuda"):
    """The JAX package's ``TetViewBatch`` arrays -> the port's
    ``TetViewBatch`` of f32 tensors on ``device``."""
    from .models.dmesh import TetViewBatch

    return TetViewBatch(*(torch.from_numpy(np.array(a, dtype=np.float32))
                          .to(device)
                          for a in (mv_t, proj_t, inv_mv_t, inv_proj_t,
                                    faces_intense, target)))


def outputs_to_numpy(outputs):
    """Tensors (nested in tuples/lists) -> NumPy arrays, same nesting."""
    if isinstance(outputs, (tuple, list)):
        return type(outputs)(outputs_to_numpy(o) for o in outputs)
    return outputs.detach().cpu().numpy()
