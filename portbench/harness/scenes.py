"""The benchmark's inputs, made from ``--seed`` on the device.

Every random value is drawn on the run's device from one
``torch.Generator(seed)``, in a few large calls, as float32, the type the
renderers take. The tet grid's connectivity is made on the host by the
benchmark's own copy of the generator (``tetgrid``), its jitter seeded by
``seed mod 2^32``. Both sides of a comparison (the program and the
reference) are handed these same tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import tetgrid


class Views(NamedTuple):
    """A pool of V views: transposed modelview and projection [V, 4, 4],
    per-view vertex depths [V, P] (tri only, else None), face intensities
    [V, F] and target images [V, 3, H, W] (train cells only, else None)."""
    mv_t: torch.Tensor
    proj_t: torch.Tensor
    vdepth: torch.Tensor | None
    finten: torch.Tensor
    target: torch.Tensor | None

    def take(self, idx):
        """Views ``idx`` (a list of pool positions), as a new Views."""
        i = torch.as_tensor(idx, dtype=torch.long, device=self.mv_t.device)
        return Views(*(None if x is None else x.index_select(0, i)
                       for x in self))


class Scene(NamedTuple):
    renderer: str
    verts: torch.Tensor       # [P, 3]
    faces: torch.Tensor       # [F, 3] int32
    vcolor: torch.Tensor      # [P, 3]
    fopac: torch.Tensor       # [F]
    bg: torch.Tensor          # [3]
    tets: torch.Tensor | None       # [T, 4] int32 (tet)
    face_tets: torch.Tensor | None  # [F, 2] int32 (tet)
    tet_faces: torch.Tensor | None  # [T, 4] int32 (tet)


def _look_at(eye):
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


def ring_cameras(cam: dict, n_views: int):
    """Row-major modelview and projection [V, 4, 4] of ``n_views`` cameras
    on a ring (radius, height) looking at the origin through a square
    frustum (fov, near, far)."""
    fl = 1.0 / np.tan(np.deg2rad(cam["fov_deg"]) / 2)
    near, far = cam["near"], cam["far"]
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = fl
    proj[1, 1] = fl
    proj[2, 2] = (far + near) / (far - near)
    proj[2, 3] = -2 * far * near / (far - near)
    proj[3, 2] = 1.0
    r, h = cam["radius"], cam["height"]
    mvs = [_look_at([r * np.cos(a), h, r * np.sin(a)])
           for a in (2 * np.pi * i / max(n_views, 1) + cam["phase"]
                     for i in range(n_views))]
    return np.stack(mvs), np.stack([proj] * n_views)


def _u(gen, n, lo, hi, dev):
    return torch.rand(n, generator=gen, device=dev) * (hi - lo) + lo


def _targets(gen, n_views, H, W, dev):
    """Smooth targets in [0.3, 0.7]: 25x25 noise per channel, bilinear."""
    low = torch.rand((n_views, 3, 25, 25), generator=gen, device=dev)
    up = torch.nn.functional.interpolate(low, size=(H, W), mode="bilinear",
                                         align_corners=False)
    return (0.3 + 0.4 * up).contiguous()


def make_scene(cfg: dict, seed: int, dev) -> tuple[Scene, torch.Generator]:
    """The configuration's scene from ``seed`` on ``dev``, and the generator
    that drew it (the views are drawn from it next)."""
    dev = torch.device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 64))
    sc = cfg["scene"]
    bg = torch.tensor(cfg["bg"], dtype=torch.float32, device=dev)
    if cfg["renderer"] == "tri":
        n = int(cfg["faces"])
        c, o = sc["center_range"], sc["offset_range"]
        centers = _u(gen, (n, 1, 3), -c, c, dev)
        offsets = _u(gen, (n, 3, 3), -o, o, dev)
        verts = (centers + offsets).reshape(-1, 3).contiguous()
        faces = torch.arange(3 * n, dtype=torch.int32, device=dev).reshape(
            n, 3)
        vcolor = _u(gen, (3 * n, 3), *sc["color"], dev)
        fopac = _u(gen, (n,), *sc["opacity"], dev)
        return Scene("tri", verts, faces, vcolor, fopac, bg, None, None,
                     None), gen
    verts, tets = tetgrid.freudenthal_grid(int(cfg["grid"]),
                                           jitter=float(cfg["jitter"]),
                                           seed=int(seed) % (1 << 32))
    faces, face_tets, tet_faces = tetgrid.build_tet_connectivity(tets)
    P, F = verts.shape[0], faces.shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    vcolor = _u(gen, (P, 3), *sc["color"], dev)
    fopac = _u(gen, (F,), *sc["opacity"], dev)
    return Scene("tet", t(verts), t(faces), vcolor, fopac, bg, t(tets),
                 t(face_tets), t(tet_faces)), gen


def make_views(cfg: dict, scene: Scene, gen: torch.Generator, n_views: int,
               targets: bool) -> Views:
    """A pool of ``n_views`` ring views of ``scene`` with their per-view
    inputs drawn from ``gen``."""
    dev = scene.verts.device
    mv, proj = ring_cameras(cfg["cameras"], n_views)
    mv_t = torch.from_numpy(mv).to(dev).transpose(1, 2).contiguous()
    proj_t = torch.from_numpy(proj).to(dev).transpose(1, 2).contiguous()
    sc = cfg["scene"]
    P, F = scene.verts.shape[0], scene.faces.shape[0]
    vdepth = (_u(gen, (n_views, P), *sc["verts_depth"], dev)
              if scene.renderer == "tri" else None)
    finten = _u(gen, (n_views, F), *sc["intensity"], dev)
    target = (_targets(gen, n_views, cfg["height"], cfg["width"], dev)
              if targets else None)
    return Views(mv_t, proj_t, vdepth, finten, target)


def leaves(scene: Scene):
    """The learnable tensors of the scene, as fresh leaves: tri (verts,
    vcolor, fopac), tet (vcolor, fopac)."""
    src = ((scene.verts, scene.vcolor, scene.fopac) if scene.renderer == "tri"
           else (scene.vcolor, scene.fopac))
    return [x.detach().clone().requires_grad_(True) for x in src]


LEAF_NAMES = {"tri": ("verts", "verts_color", "faces_opacity"),
              "tet": ("verts_color", "faces_opacity")}
