"""Fit tet-face colours and opacities to target images (DMesh phase 2),
with the PyTorch port (``dmesh_renderer_tpu_torch``).

The port's counterpart of ``examples/optimize_tet.py``. The tet renderer
gives exact depth order through a tetrahedral tessellation; DMesh optimises
per-face opacities (which faces exist) and vertex colours against
multi-view targets, leaving out the pixels the renderer marks inactive. The
views are sharded over ``--ranks`` processes (one view mesh,
``parallel.make_view_mesh``), with a checkpoint at the midpoint and one step
resumed from it.

Run (the card by default; ranks that share one card use gloo):
    python examples/port_optimize_tet.py
    python examples/port_optimize_tet.py --device cpu --ranks 2
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dmesh_renderer_tpu_torch import parallel  # noqa: E402
from dmesh_renderer_tpu_torch.api import resolve_device  # noqa: E402
from dmesh_renderer_tpu_torch.models.dmesh import (  # noqa: E402
    TetGeometry, TetScene, TetViewBatch, init_tet_train_state,
    make_tet_train_step,
)
from dmesh_renderer_tpu_torch.ops.tet import render_tet_core  # noqa: E402
from dmesh_renderer_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint, save_checkpoint,
)
from dmesh_renderer_tpu_torch.utils.connectivity import (  # noqa: E402
    build_tet_connectivity, freudenthal_grid,
)

H = W = 64
SPAWN_TIMEOUT = 900.0  # seconds for the whole run of every rank


def look_cameras(n, radius=3.0):
    """Row-major modelview and projection [n, 4, 4] of ``n`` cameras on a
    ring at height 0.7, looking at the origin (45-degree frustum)."""
    fl = 1.0 / np.tan(np.deg2rad(45.0) / 2)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = fl
    proj[1, 1] = fl
    proj[2, 2] = (10.0 + 0.1) / (10.0 - 0.1)
    proj[2, 3] = -2 * 10.0 * 0.1 / (10.0 - 0.1)
    proj[3, 2] = 1.0
    mvs = []
    for i in range(n):
        ang = 2 * np.pi * i / n + 0.35
        eye = np.array([radius * np.cos(ang), 0.7, radius * np.sin(ang)])
        f = -eye / np.linalg.norm(eye)
        s = np.cross(f, [0, 1, 0])
        s /= np.linalg.norm(s)
        u = np.cross(s, f)
        m = np.eye(4, dtype=np.float32)
        m[0, :3], m[1, :3], m[2, :3] = s, -u, f
        m[:3, 3] = -m[:3, :3] @ eye
        mvs.append(m)
    return np.stack(mvs), np.stack([proj] * n)


def fit(device, ranks, steps, out_dir):
    """The optimisation on this process (one rank of ``ranks``): returns the
    losses, the resumed step's loss, the colour error and the checkpoint's
    path."""
    dev = resolve_device(device)
    n_views = max(1, min(4, ranks))
    mesh = None
    if ranks > 1:
        # on the card, rank r takes card r % count
        mesh = parallel.make_view_mesh(
            min(n_views, ranks), device=None if dev.type == "cuda" else dev)
        if mesh is None:  # a rank beyond the views has nothing to render
            return None
        dev = mesh.device
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)

    def t(x, dtype=np.float32):
        return torch.from_numpy(np.asarray(x, dtype)).to(dev)

    verts, tets = freudenthal_grid(3, jitter=0.1, seed=0)
    faces, face_tets, tet_faces = build_tet_connectivity(tets)
    say(f"device: {dev}, ranks: {ranks}, views: {n_views}; tessellation: "
        f"{tets.shape[0]} tets, {faces.shape[0]} faces")
    geom = TetGeometry(t(verts), *(t(a, np.int32) for a in (
        faces, tets, face_tets, tet_faces)))
    rng = np.random.RandomState(0)
    gt = TetScene(t(rng.rand(verts.shape[0], 3)),
                  t(rng.uniform(0.5, 0.95, faces.shape[0])))
    mv, proj = look_cameras(n_views)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    mats = [t(m) for m in (mv_t, proj_t, np.linalg.inv(mv_t),
                           np.linalg.inv(proj_t))]
    fintense = torch.ones(n_views, faces.shape[0], device=dev)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():  # the targets: the ground truth's render
        target, _, _ = render_tet_core(
            geom.verts, geom.faces, gt.verts_color, gt.faces_opacity, *mats,
            fintense, geom.tets, geom.face_tets, geom.tet_faces, bg, H, W, 0)
    batch = TetViewBatch(*mats, fintense, target)
    if mesh is not None:
        batch = parallel.shard_view_batch(mesh, batch)

    def fresh_state():
        scene = TetScene(
            torch.full((verts.shape[0], 3), 0.5, device=dev,
                       requires_grad=True),
            torch.full((faces.shape[0],), 0.5, device=dev,
                       requires_grad=True))
        if mesh is not None:
            scene = parallel.replicate_params(mesh, scene)
        # capturable: on the card the step runs as CUDA graphs (the CPU's
        # Adam refuses the flag)
        return init_tet_train_state(scene, lambda p: torch.optim.Adam(
            p, lr=2e-2, capturable=dev.type == "cuda"))

    state = fresh_state()
    step = make_tet_train_step(geom, bg, H, W, mesh=mesh)
    ckpt = os.path.join(out_dir, "ckpt_tet.pt")
    losses = []
    for i in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
        if i % 10 == 0 or i == steps - 1:
            say(f"step {i:4d}  masked-mse {losses[-1]:.6f}")
        if i == steps // 2:
            save_checkpoint(ckpt, state, mesh=mesh)
            say(f"checkpointed at step {i} -> {ckpt}")

    err = float((state.scene.verts_color.detach() - gt.verts_color).abs()
                .mean())
    say(f"mean |vcolor - gt|: {err:.4f}")
    # resume: the midpoint checkpoint restored into a fresh state, one step
    _, loss_r = step(restore_checkpoint(ckpt, fresh_state()), batch)
    resumed = float(loss_r)
    say(f"resumed-from-checkpoint masked-mse: {resumed:.6f}")
    return {"losses": losses, "resumed_loss": resumed, "vcolor_err": err,
            "checkpoint": ckpt}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes, one view shard each (default 1)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--out-dir", default=os.path.join(
        tempfile.gettempdir(), "dmrt_port_fit"))
    a = ap.parse_args(argv)
    args = (a.device, a.ranks, a.steps, a.out_dir)
    if a.ranks == 1:
        return fit(*args)
    return parallel.spawn(fit, a.ranks, args,
                          backend=parallel.default_backend(a.ranks, a.device),
                          timeout=SPAWN_TIMEOUT)[0]


if __name__ == "__main__":
    main()
