"""Tetrahedral connectivity and a tessellation generator (NumPy only).

The benchmark's own copy of the generator of the tet scenes, so that a
change to the program cannot change the inputs. The tet renderer consumes
three connectivity arrays:

  tets      [T, 4]  vertex ids of each tet
  face_tets [F, 2]  the (up to 2) tets adjacent to each face, -1 padded
  tet_faces [T, 4]  the 4 faces of each tet

``build_tet_connectivity`` derives ``faces``, ``face_tets`` and
``tet_faces`` from ``tets`` alone; ``freudenthal_grid`` makes a conformal
tessellation of a cube at any scale.
"""

from __future__ import annotations

import numpy as np

# vertex index triples of the 4 faces of a tet (opposite vertex 3,2,1,0)
_TET_FACE_CORNERS = np.array(
    [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], dtype=np.int64
)


def build_tet_connectivity(tets: np.ndarray):
    """Derive (faces [F, 3] int32, face_tets [F, 2] int32 (-1 padded),
    tet_faces [T, 4] int32) from tets [T, 4]. Faces are numbered in the
    lexicographic order of their sorted vertex ids; a face keeps the corner
    order of the first tet that introduces it, and its two owners are the
    first two in tet order."""
    tets = np.asarray(tets, np.int64)
    T = tets.shape[0]

    cand_flat = tets[:, _TET_FACE_CORNERS].reshape(-1, 3)  # [4T, 3]
    key = np.sort(cand_flat, axis=1)
    uniq, first_idx, inverse = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    inverse = inverse.reshape(-1)
    F = uniq.shape[0]

    faces = cand_flat[first_idx].astype(np.int32)
    tet_faces = inverse.reshape(T, 4).astype(np.int32)

    owner = np.repeat(np.arange(T, dtype=np.int64), 4)
    counts = np.bincount(inverse, minlength=F)
    if (counts > 2).any():
        raise ValueError("non-manifold tessellation: face shared by >2 tets")
    # group the incidences by face in tet order; each face's rank within its
    # group selects its first two owners
    order = np.argsort(inverse, kind="stable")
    fid_s = inverse[order]
    own_s = owner[order]
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(4 * T, dtype=np.int64) - start[fid_s]
    face_tets = np.full((F, 2), -1, np.int32)
    sel = rank < 2
    face_tets[fid_s[sel], rank[sel]] = own_s[sel]
    return faces, face_tets, tet_faces


# Freudenthal (Kuhn) 6-tet cube split: each tet follows the main diagonal
# via one of the 6 axis orders, which makes the split conformal across
# neighbouring cubes.
_KUHN_AXIS_ORDERS = np.array(
    [[0, 1, 2], [0, 2, 1], [1, 0, 2], [1, 2, 0], [2, 0, 1], [2, 1, 0]],
    dtype=np.int64,
)


def freudenthal_grid(n: int, jitter: float = 0.0, seed: int = 0):
    """A conformal tetrahedral tessellation of the cube [-1, 1]^3: n cubes
    per axis, 6 tets per cube, so T = 6 n^3 tets and ~12 n^3 faces.

    ``jitter``: uniform vertex perturbation as a fraction of the cell size,
    drawn from ``RandomState(seed)``. Returns (verts [P, 3] float32,
    tets [T, 4] int32)."""
    g = np.arange(n + 1, dtype=np.float32) / n * 2.0 - 1.0
    verts = np.stack(
        np.meshgrid(g, g, g, indexing="ij"), axis=-1
    ).reshape(-1, 3).astype(np.float32)
    if jitter > 0.0:
        rng = np.random.RandomState(seed)
        verts = verts + rng.uniform(
            -jitter, jitter, verts.shape
        ).astype(np.float32) * (2.0 / n)

    ii, jj, kk = np.meshgrid(
        np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64),
        np.arange(n, dtype=np.int64), indexing="ij",
    )
    base = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)  # [n^3, 3]
    eye = np.eye(3, dtype=np.int64)

    tet_corners = []
    for order in _KUHN_AXIS_ORDERS:
        c0 = base
        c1 = c0 + eye[order[0]]
        c2 = c1 + eye[order[1]]
        c3 = c2 + eye[order[2]]
        tet_corners.append(np.stack([c0, c1, c2, c3], axis=1))
    corners = np.concatenate(tet_corners, axis=0)  # [6 n^3, 4, 3]
    tets = (
        (corners[..., 0] * (n + 1) + corners[..., 1]) * (n + 1)
        + corners[..., 2]
    ).astype(np.int32)
    return verts, tets
