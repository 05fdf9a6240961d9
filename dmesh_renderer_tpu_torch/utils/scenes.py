"""The headline benchmark scenes (NumPy only).

``tri_scene``: a seeded random triangle soup and ring cameras, the same
generator and random stream as ``__graft_entry__._scene`` of the repository
(copied, so that the port's scripts need nothing outside the port);
``tri_scene(100_000, 1, 800, 800, seed=0)`` is the tri headline.

``tet_scene``: the jittered Freudenthal tessellation of the repository's
tet benchmark (``bench.py``, ``bench_tet_scaled``) with its colours,
opacities and intensities, seen by the same ring cameras;
``tet_scene(20, 1, 800, 800)`` is the tet headline (98,400 faces, 48,000
tets).
"""

from __future__ import annotations

import numpy as np


def look_at(eye):
    """Row-major modelview looking from ``eye`` at the origin, y down."""
    eye = np.asarray(eye, np.float64)
    f = -eye / np.linalg.norm(eye)
    s = np.cross(f, [0, 1, 0])
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = -u
    m[2, :3] = f
    m[:3, 3] = -m[:3, :3] @ eye
    return m.astype(np.float32)


def ring_cameras(n_views):
    """Row-major (untransposed) modelview and projection [B, 4, 4] of
    ``n_views`` cameras on a ring of radius 3 at height 0.8, looking at the
    origin through a square 45-degree frustum (near 0.1, far 10)."""
    fl = 1.0 / np.tan(np.deg2rad(45.0) / 2)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = fl
    proj[1, 1] = fl
    proj[2, 2] = (10.0 + 0.1) / (10.0 - 0.1)
    proj[2, 3] = -2 * 10.0 * 0.1 / (10.0 - 0.1)
    proj[3, 2] = 1.0

    mvs = []
    for i in range(n_views):
        ang = 2 * np.pi * i / max(n_views, 1) + 0.3
        mvs.append(look_at([3 * np.cos(ang), 0.8, 3 * np.sin(ang)]))
    return np.stack(mvs), np.stack([proj] * n_views)


def tri_scene(n_tris, n_views, height, width, seed=0):
    """Random triangle soup + ring cameras.

    Returns (verts [3n, 3], faces [n, 3] int32, verts_color, faces_opacity,
    mv [B, 4, 4], proj [B, 4, 4] (row-major, untransposed), verts_depth
    [B, 3n], faces_intense [B, n]). ``height``/``width`` do not enter the
    scene (square 45-degree frustum); they are kept for the call signature.
    """
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-1, 1, size=(n_tris, 1, 3))
    offsets = rng.uniform(-0.25, 0.25, size=(n_tris, 3, 3))
    verts = (centers + offsets).reshape(-1, 3).astype(np.float32)
    faces = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    vcolor = rng.uniform(0, 1, size=(verts.shape[0], 3)).astype(np.float32)
    fopacity = rng.uniform(0.2, 0.95, size=(n_tris,)).astype(np.float32)
    mv, projm = ring_cameras(n_views)

    vdepth = rng.uniform(-1, 1, size=(n_views, verts.shape[0])).astype(
        np.float32)
    fintense = rng.uniform(0.5, 1.0, size=(n_views, n_tris)).astype(
        np.float32)
    return verts, faces, vcolor, fopacity, mv, projm, vdepth, fintense


def tet_scene(n_grid, n_views, height, width):
    """The tet benchmark scene: ``freudenthal_grid(n_grid, jitter=0.15,
    seed=2)``, ``RandomState(0)`` vertex colours U[0, 1), face opacities
    U(0.3, 0.9) and per-view face intensities U(0.5, 1.0), the ring cameras
    and a 0.1 grey background.

    Returns the eleven inputs of ``TetRenderer`` in call order (verts,
    faces, verts_color, faces_opacity, mv, proj (row-major, untransposed),
    verts_depth (zeros; the tet renderer does not use it), faces_intense,
    tets, face_tets, tet_faces) and bg [3]. ``height``/``width`` do not
    enter the scene; they are kept for the call signature."""
    from .connectivity import build_tet_connectivity, freudenthal_grid

    verts, tets = freudenthal_grid(n_grid, jitter=0.15, seed=2)
    faces, face_tets, tet_faces = build_tet_connectivity(tets)
    rng = np.random.RandomState(0)
    vcolor = rng.rand(verts.shape[0], 3).astype(np.float32)
    fopacity = rng.uniform(0.3, 0.9, faces.shape[0]).astype(np.float32)
    fintense = rng.uniform(0.5, 1.0,
                           (n_views, faces.shape[0])).astype(np.float32)
    mv, proj = ring_cameras(n_views)
    vdepth = np.zeros((n_views, verts.shape[0]), np.float32)
    bg = np.array([0.1, 0.1, 0.1], np.float32)
    return (verts, faces, vcolor, fopacity, mv, proj, vdepth, fintense,
            tets, face_tets, tet_faces, bg)
