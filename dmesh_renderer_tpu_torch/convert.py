"""Carry the JAX functional call's arrays into the port's tensors and back.

``tri_inputs_from_numpy`` takes the eleven arrays of the JAX package's
functional tri call (``render_tri_auto`` / ``render_tri_binned`` /
``render_tri_oracle`` order, matrices transposed, inverse matrices given)
and returns the port's tensors holding the same bits, so that both packages
can be fed identical inputs, inverse matrices included.
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


def outputs_to_numpy(outputs):
    """Tensors (nested in tuples/lists) -> NumPy arrays, same nesting."""
    if isinstance(outputs, (tuple, list)):
        return type(outputs)(outputs_to_numpy(o) for o in outputs)
    return outputs.detach().cpu().numpy()
