"""The headline benchmark scene: a seeded random triangle soup and ring
cameras (NumPy only).

The same generator and random stream as ``__graft_entry__._scene`` of the
repository (copied, so that the port's scripts need nothing outside the
port): ``tri_scene(100_000, 1, 800, 800, seed=0)`` is the headline scene.
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
    mv = np.stack(mvs)
    projm = np.stack([proj] * n_views)

    vdepth = rng.uniform(-1, 1, size=(n_views, verts.shape[0])).astype(
        np.float32)
    fintense = rng.uniform(0.5, 1.0, size=(n_views, n_tris)).astype(
        np.float32)
    return verts, faces, vcolor, fopacity, mv, projm, vdepth, fintense
