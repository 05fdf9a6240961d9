"""DMesh-style multi-view optimisation of a triangle scene, in PyTorch.

A port of the tri half of the JAX package's ``models/dmesh.py``: a batch of
camera views is rendered, compared with target images by an L2 loss, and
the scene parameters (vertex positions and colours, face opacities) take an
optimiser step. The tet half waits for the tet renderer's port.

Where the JAX package threads an optax state through a jitted pure step,
the port keeps a ``torch.optim`` optimiser over the scene's leaf tensors in
``TrainState.opt_state`` and steps it in place: ``init_train_state`` builds
it from a factory (``params -> optimizer``), and the step and the loop use
it. Multi-device training (``mesh=``) is the ``torch.distributed`` slice of
the port and raises ``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..ops.tri import render_tri_auto


class TriScene(NamedTuple):
    """Learnable scene parameters, shared across views (leaf tensors)."""
    verts: torch.Tensor          # [P, 3]
    verts_color: torch.Tensor    # [P, 3]
    faces_opacity: torch.Tensor  # [F]


class ViewBatch(NamedTuple):
    """Per-view inputs (leading axis = views)."""
    mv_t: torch.Tensor           # [B, 4, 4] transposed modelview
    proj_t: torch.Tensor         # [B, 4, 4] transposed projection
    inv_mv_t: torch.Tensor       # [B, 4, 4]
    inv_proj_t: torch.Tensor     # [B, 4, 4]
    verts_depth: torch.Tensor    # [B, P]
    faces_intense: torch.Tensor  # [B, F]
    target: torch.Tensor         # [B, 3, H, W] target images


class TrainState(NamedTuple):
    scene: TriScene
    view_params: Any                   # per-view learned params, or None
    opt_state: torch.optim.Optimizer   # steps ``scene`` in place


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "multi-device training (mesh=) is not ported yet: it lands with "
            "the torch.distributed view sharding of the port")


def render_views(scene: TriScene, faces, batch: ViewBatch, bg, height: int,
                 width: int, force: str | None = None,
                 kcap: int | None = None):
    """Render ``batch``'s views of ``scene``: (color [B, 3, H, W],
    depth [B, 1, H, W])."""
    return render_tri_auto(
        scene.verts, faces, scene.verts_color, scene.faces_opacity,
        batch.mv_t, batch.proj_t, batch.inv_mv_t, batch.inv_proj_t,
        batch.verts_depth, batch.faces_intense, bg, height, width,
        force=force, kcap=kcap)


def make_loss_fn(faces, bg, height: int, width: int,
                 force: str | None = None, kcap: int | None = None):
    """``loss_fn(scene, batch)``: the mean squared error of the rendered
    colour against ``batch.target``."""
    def loss_fn(scene: TriScene, batch: ViewBatch):
        color, _depth = render_views(scene, faces, batch, bg, height, width,
                                     force=force, kcap=kcap)
        return torch.mean((color - batch.target) ** 2)
    return loss_fn


def init_train_state(
        scene: TriScene,
        optimizer: Callable[[list], torch.optim.Optimizer]) -> TrainState:
    """A train state whose optimiser, ``optimizer(list(scene))``, updates
    the scene's tensors (leaves that require grad)."""
    return TrainState(scene, None, optimizer(list(scene)))


def make_train_step(faces, bg, height: int, width: int, mesh=None,
                    force: str | None = None, kcap: int | None = None):
    """``step(state, batch) -> (state, loss)``: one render, the loss, its
    five-gradient backward and one optimiser step on ``state.scene``.
    ``loss`` is detached."""
    _no_mesh(mesh)
    loss_fn = make_loss_fn(faces, bg, height, width, force=force, kcap=kcap)

    def step(state: TrainState, batch: ViewBatch):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(state.scene, batch)
        loss.backward()
        opt.step()
        return state, loss.detach()

    return step


def make_train_loop(faces, bg, height: int, width: int, n_steps: int,
                    mesh=None, force: str | None = None,
                    kcap: int | None = None):
    """``loop(state, batch) -> (state, losses [n_steps])``: ``n_steps``
    train steps on the same batch."""
    step = make_train_step(faces, bg, height, width, mesh=mesh, force=force,
                           kcap=kcap)

    def loop(state: TrainState, batch: ViewBatch):
        losses = []
        for _ in range(n_steps):
            state, loss = step(state, batch)
            losses.append(loss)
        return state, torch.stack(losses)

    return loop
