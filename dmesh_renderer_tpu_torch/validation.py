"""Input validation at the API boundary (shape contracts of the renderers).

The messages are those of the JAX package, so callers that match on them
see the same text from either package.
"""

from __future__ import annotations


def _chk(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"dmesh_renderer_tpu: {msg}")


def check_tri_inputs(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                     verts_depth, faces_intense, bg):
    """Shape contract of the tri renderer. ``verts_depth`` may be None."""
    _chk(verts.ndim == 2 and verts.shape[1] == 3,
         f"verts must be [P,3], got {tuple(verts.shape)}")
    _chk(faces.ndim == 2 and faces.shape[1] == 3,
         f"faces must be [F,3], got {tuple(faces.shape)}")
    P = verts.shape[0]
    F = faces.shape[0]
    _chk(tuple(verts_color.shape) == (P, 3),
         f"verts_color must be [P,3]=({P},3), got {tuple(verts_color.shape)}")
    _chk(tuple(faces_opacity.shape) == (F,),
         f"faces_opacity must be [F]=({F},), got "
         f"{tuple(faces_opacity.shape)}")
    _chk(mv_t.ndim == 3 and tuple(mv_t.shape[1:]) == (4, 4),
         f"mv_mats must be [B,4,4], got {tuple(mv_t.shape)}")
    B = mv_t.shape[0]
    _chk(tuple(proj_t.shape) == (B, 4, 4),
         f"proj_mats must be [B,4,4]=({B},4,4), got {tuple(proj_t.shape)}")
    if verts_depth is not None:
        _chk(tuple(verts_depth.shape) == (B, P),
             f"verts_depth must be [B,P]=({B},{P}), got "
             f"{tuple(verts_depth.shape)}")
    _chk(tuple(faces_intense.shape) == (B, F),
         f"faces_intense must be [B,F]=({B},{F}), got "
         f"{tuple(faces_intense.shape)}")
    _chk(tuple(bg.shape) == (3,), f"bg must be [3], got {tuple(bg.shape)}")
    # the same face-count limit as the JAX package, so both packages accept
    # the same scenes
    _chk(F < (1 << 24),
         f"at most 2^24-1 faces supported (ids ride in f32-exact columns "
         f"of the binned pipelines), got F={F}")


def check_tet_inputs(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                     faces_intense, tets, face_tets, tet_faces, bg):
    """Shape contract of the tet renderer (``verts_depth`` is not used)."""
    check_tri_inputs(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                     None, faces_intense, bg)
    F = faces.shape[0]
    _chk(tets.ndim == 2 and tets.shape[1] == 4,
         f"tets must be [T,4], got {tuple(tets.shape)}")
    T = tets.shape[0]
    _chk(tuple(face_tets.shape) == (F, 2),
         f"face_tets must be [F,2]=({F},2), got {tuple(face_tets.shape)}")
    _chk(tuple(tet_faces.shape) == (T, 4),
         f"tet_faces must be [T,4]=({T},4), got {tuple(tet_faces.shape)}")
    # the same tet-count limit as the JAX package, so both packages accept
    # the same scenes
    _chk(T < (1 << 22),
         f"at most 2^22-1 tets supported (entry-slot gather indices "
         f"tet*4+slot ride in f32-exact march tables), got T={T}")
