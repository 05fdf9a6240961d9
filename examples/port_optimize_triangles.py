"""Fit a semi-transparent triangle soup to target images, with the PyTorch
port (``dmesh_renderer_tpu_torch``).

The port's counterpart of ``examples/optimize_triangles.py``, the canonical
use case of the reference renderer: DMesh-style multi-view optimisation.
It renders the views of a randomly initialised soup, compares them with
target images of an 8-petal "flower", and steps vertex positions, colours
and face opacities with Adam -- with the views sharded over ``--ranks``
processes (one view mesh, ``parallel.make_view_mesh``), a checkpoint at the
midpoint, and one step resumed from it.

Run (the card by default; each rank needs a card of its own for NCCL, and
ranks that share one card use gloo):
    python examples/port_optimize_triangles.py
    python examples/port_optimize_triangles.py --device cpu --ranks 2
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
    TriScene, ViewBatch, init_train_state, make_train_step, render_views,
)
from dmesh_renderer_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint, save_checkpoint,
)
from dmesh_renderer_tpu_torch.utils.scenes import look_at  # noqa: E402

H = W = 48
N_TRIS = 48
SPAWN_TIMEOUT = 900.0  # seconds for the whole run of every rank


def flower():
    """The target scene: 8 coloured triangles on a ring, at staggered
    depths."""
    verts, faces, colors = [], [], []
    for i, a in enumerate(np.linspace(0, 2 * np.pi, 9)[:-1]):
        c = np.array([np.cos(a), np.sin(a), 0.0]) * 0.7
        verts += [c + [0, 0, 0.1 * i - 0.4], c + [0.5, 0, 0.1 * i - 0.4],
                  c + [0, 0.5, 0.1 * i - 0.4]]
        faces.append([3 * i, 3 * i + 1, 3 * i + 2])
        col = np.zeros(3)
        col[i % 3] = 1.0
        colors += [col] * 3
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            np.asarray(colors, np.float32),
            np.full(len(faces), 0.9, np.float32))


def cameras(n_views):
    """Transposed modelview, projection and their inverses [B, 4, 4] of
    ``n_views`` cameras on a ring of radius 3 at height 0.6 (50-degree
    frustum)."""
    fl = 1.0 / np.tan(np.deg2rad(25.0))
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = fl
    proj[1, 1] = fl
    proj[2, 2] = (10 + 0.1) / (10 - 0.1)
    proj[2, 3] = -2 * 10 * 0.1 / (10 - 0.1)
    proj[3, 2] = 1.0
    mvs = np.stack([look_at([3 * np.cos(t), 0.6, 3 * np.sin(t)])
                    for t in np.linspace(0, 2 * np.pi, n_views,
                                         endpoint=False)])
    mv_t = np.swapaxes(mvs, 1, 2).copy()
    proj_t = np.broadcast_to(proj.T, (n_views, 4, 4)).copy()
    return mv_t, proj_t, np.linalg.inv(mv_t), np.linalg.inv(proj_t)


def fit(device, ranks, steps, out_dir):
    """The optimisation on this process (one rank of ``ranks``): returns the
    losses, the resumed step's loss and the checkpoint's path."""
    dev = resolve_device(device)
    n_views = max(2, min(8, ranks))
    mesh = None
    if ranks > 1:
        # on the card, rank r takes card r % count
        mesh = parallel.make_view_mesh(
            min(n_views, ranks), device=None if dev.type == "cuda" else dev)
        if mesh is None:  # a rank beyond the views has nothing to render
            return None
        dev = mesh.device
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    say(f"device: {dev}, ranks: {ranks}, views: {n_views}")

    def t(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    mats = [t(m) for m in cameras(n_views)]
    bg = torch.zeros(3, device=dev)
    tv, tf, tc, to = flower()
    with torch.no_grad():
        target, _ = render_views(
            TriScene(t(tv), t(tc), t(to)), t(tf),
            ViewBatch(*mats, torch.zeros(n_views, tv.shape[0], device=dev),
                      torch.ones(n_views, tf.shape[0], device=dev), None),
            bg, H, W)

    P = 3 * N_TRIS
    faces = t(np.arange(P, dtype=np.int32).reshape(N_TRIS, 3))
    batch = ViewBatch(*mats, torch.zeros(n_views, P, device=dev),
                      torch.ones(n_views, N_TRIS, device=dev), target)

    def fresh_state():
        rng = np.random.RandomState(0)
        scene = TriScene(
            t((rng.rand(P, 3).astype(np.float32) - 0.5) * 2.0),
            t(rng.rand(P, 3).astype(np.float32)),
            torch.full((N_TRIS,), 0.5, device=dev))
        for x in scene:
            x.requires_grad_(True)
        if mesh is not None:
            scene = parallel.replicate_params(mesh, scene)
        # capturable: on the card the step runs as a CUDA graph (the
        # optimiser's step count stays on the device)
        return init_train_state(
            scene, lambda p: torch.optim.Adam(
                p, lr=2e-2, capturable=dev.type == "cuda"))

    if mesh is not None:
        batch = parallel.shard_view_batch(mesh, batch)
    state = fresh_state()
    step = make_train_step(faces, bg, H, W, mesh=mesh)

    ckpt = os.path.join(out_dir, "ckpt.pt")
    losses = []
    for i in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
        if i % 10 == 0 or i == steps - 1:
            say(f"step {i:4d}  loss {losses[-1]:.6f}")
        if i == steps // 2:
            save_checkpoint(ckpt, state, mesh=mesh)
            say(f"checkpointed at step {i} -> {ckpt}")

    # resume: the midpoint checkpoint restored into a fresh state, one step
    _, loss_r = step(restore_checkpoint(ckpt, fresh_state()), batch)
    resumed = float(loss_r)
    say(f"resumed-from-checkpoint loss: {resumed:.6f}")
    return {"losses": losses, "resumed_loss": resumed, "checkpoint": ckpt}


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
