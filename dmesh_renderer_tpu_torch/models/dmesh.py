"""DMesh-style multi-view optimisation, in PyTorch.

A port of the JAX package's ``models/dmesh.py``: a batch of camera views is
rendered, compared with target images by an L2 loss, and the scene
parameters take an optimiser step. The tri half optimises vertex positions
and colours and face opacities; the tet half (DMesh's second phase) renders
through the tessellation with exact depth order and optimises vertex
colours and face opacities, its loss the squared error over the pixels the
renderer marks active, divided by their count.

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

from ..ops.tet import render_tet_core
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


# =============================================================================
# Tet-renderer optimisation (gradients reach vertex colours and face
# opacities only)
# =============================================================================

class TetScene(NamedTuple):
    """Learnable tet-scene parameters (leaf tensors): the tet renderer's
    only differentiable inputs."""
    verts_color: torch.Tensor    # [P, 3]
    faces_opacity: torch.Tensor  # [F]


class TetGeometry(NamedTuple):
    """Static tessellation structure."""
    verts: torch.Tensor      # [P, 3]
    faces: torch.Tensor      # [F, 3] int32
    tets: torch.Tensor       # [T, 4] int32
    face_tets: torch.Tensor  # [F, 2] int32
    tet_faces: torch.Tensor  # [T, 4] int32


class TetViewBatch(NamedTuple):
    """Per-view inputs (leading axis = views)."""
    mv_t: torch.Tensor           # [B, 4, 4] transposed modelview
    proj_t: torch.Tensor         # [B, 4, 4] transposed projection
    inv_mv_t: torch.Tensor       # [B, 4, 4]
    inv_proj_t: torch.Tensor     # [B, 4, 4]
    faces_intense: torch.Tensor  # [B, F]
    target: torch.Tensor         # [B, 3, H, W] target images


def make_tet_se_fn(geom: TetGeometry, bg, height: int, width: int,
                   seed: int = 0):
    """``se_fn(scene, batch, view_offset=None) -> (se, count)``: the squared
    error of the rendered colour against ``batch.target`` summed over the
    active pixels (inactive ones render pure background and are left out),
    and the number of values summed (3 per active pixel). ``view_offset``
    is the global index of the batch's view 0, which keys the per-view ray
    jitter (``seed`` > 0) when the batch is one shard of more views."""
    def se_fn(scene: TetScene, batch: TetViewBatch, view_offset=None):
        color, _depth, active = render_tet_core(
            geom.verts, geom.faces, scene.verts_color, scene.faces_opacity,
            batch.mv_t, batch.proj_t, batch.inv_mv_t, batch.inv_proj_t,
            batch.faces_intense, geom.tets, geom.face_tets, geom.tet_faces,
            bg, height, width, seed, view_offset=view_offset)
        m = active[:, None].to(torch.float32)
        return torch.sum(m * (color - batch.target) ** 2), torch.sum(m) * 3.0
    return se_fn


def init_tet_train_state(
        scene: TetScene,
        optimizer: Callable[[list], torch.optim.Optimizer]) -> TrainState:
    """A train state whose optimiser, ``optimizer(list(scene))``, updates
    the tet scene's tensors (leaves that require grad)."""
    return TrainState(scene, None, optimizer(list(scene)))


def make_tet_train_step(geom: TetGeometry, bg, height: int, width: int,
                        mesh=None, seed: int = 0):
    """``step(state, batch) -> (state, loss)``: one render, the masked mean
    squared error ``se / max(count, 1)``, its backward and one optimiser
    step on ``state.scene``. ``loss`` is detached."""
    _no_mesh(mesh)
    se_fn = make_tet_se_fn(geom, bg, height, width, seed)

    def step(state: TrainState, batch: TetViewBatch):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        se, cnt = se_fn(state.scene, batch)
        loss = se / torch.clamp_min(cnt, 1.0)
        loss.backward()
        opt.step()
        return state, loss.detach()

    return step


def make_tet_train_loop(geom: TetGeometry, bg, height: int, width: int,
                        n_steps: int, mesh=None, seed: int = 0):
    """``loop(state, batch) -> (state, losses [n_steps])``: ``n_steps``
    tet train steps on the same batch."""
    step = make_tet_train_step(geom, bg, height, width, mesh=mesh, seed=seed)

    def loop(state: TrainState, batch: TetViewBatch):
        losses = []
        for _ in range(n_steps):
            state, loss = step(state, batch)
            losses.append(loss)
        return state, torch.stack(losses)

    return loop
