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
it.

On the card, the tri train step and loop are what the JAX package's
``jax.jit(step)`` and ``jax.jit(lax.scan(...))`` are: programs that run
with no host work per op. The binned tri frame has static shapes and reads
nothing on the host under capture (``ops/tri_binned.py``), so ``TrainStep``
runs the first call for a batch shape as an ordinary eager step (which also
builds every lazily made table and the optimiser's state), captures the
second -- zero_grad, forward, backward, ``opt.step()`` -- into a
``torch.cuda.CUDAGraph`` on a side stream and replays it, and replays it on
every later call, after copying the batch into the graph's static inputs.
The optimiser must be capturable (``torch.optim.Adam(...,
capturable=True)``); a step whose optimiser is not raises on the card. A
batch of other shapes captures a graph of its own, as ``jit`` retraces; an
optimiser whose state tensors were replaced (``opt.load_state_dict``, a
checkpoint restore) or a new optimiser takes an eager step and captures
again. ``mesh=`` steps (their all-reduce goes through the host), the dense
oracle, and the CPU stay eager.

Multi-view training (``mesh=``, a ``parallel.make_view_mesh`` mesh): each
rank renders its own views (``parallel.shard_view_batch``) with its own copy
of the scene (``parallel.replicate_params``), runs backward, and the
gradients of the view-shared parameters and the loss pieces are summed over
the ranks by one all-reduce of one flat buffer per step, as the JAX
package's ``shard_map`` steps do with ``pmean`` (tri) and ``psum`` (tet).
Every rank then takes the same optimiser step on the same bits.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..ops.tet import render_tet_core
from ..ops.binning import default_key_capacity, warn_if_overflow
from ..ops.tri import render_tri_auto, tri_strategy
from ..parallel.sharding import ViewMesh, all_reduce


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


def _check_mesh(mesh):
    if mesh is not None and not isinstance(mesh, ViewMesh):
        raise TypeError(
            "mesh= takes the ViewMesh that parallel.make_view_mesh() "
            f"returns, not a {type(mesh).__name__}")


def _sum_over_views(mesh: ViewMesh | None, params, scalars, denom):
    """The flat buffer [every param's gradient, *scalars], summed over the
    mesh by one all-reduce (no collective without a mesh), divided by
    ``denom(summed buffer)``: the divided gradients go into ``.grad``, and
    the first divided scalar (the loss) is returned, copied out of the
    buffer so that it does not keep the gradients alive. One collective of
    one buffer keeps the sum's order fixed, every rank's bits equal and the
    host cost of a step to one call."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [s.detach().reshape(1) for s in scalars])
    if mesh is not None:
        flat = all_reduce(mesh, flat)
    flat = flat / denom(flat)
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    return flat[off].clone()


def render_views(scene: TriScene, faces, batch: ViewBatch, bg, height: int,
                 width: int, force: str | None = None,
                 kcap: int | None = None, **kw):
    """Render ``batch``'s views of ``scene``: (color [B, 3, H, W],
    depth [B, 1, H, W]); ``kw`` goes to ``render_tri_auto``
    (``with_aux``, ``warn_overflow``)."""
    return render_tri_auto(
        scene.verts, faces, scene.verts_color, scene.faces_opacity,
        batch.mv_t, batch.proj_t, batch.inv_mv_t, batch.inv_proj_t,
        batch.verts_depth, batch.faces_intense, bg, height, width,
        force=force, kcap=kcap, **kw)


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


def _require_capturable(opt: torch.optim.Optimizer) -> None:
    if not all(g.get("capturable", False) for g in opt.param_groups):
        raise RuntimeError(
            "make_train_step: on the card the tri train step is captured as "
            "a CUDA graph, which needs a capturable optimiser (e.g. "
            "torch.optim.Adam(params, capturable=True)); this "
            f"{type(opt).__name__} is not. Pass capture=False to keep every "
            "step eager.")


def _fingerprint(state: TrainState) -> tuple:
    """What a captured step bakes in besides the batch: the optimiser, its
    hyperparameters and the addresses of the scene's tensors and of the
    optimiser's state tensors."""
    opt = state.opt_state
    out = [id(opt), *(p.data_ptr() for p in state.scene)]
    for g in opt.param_groups:
        out.append(tuple((k, ("tensor", v.data_ptr())
                          if isinstance(v, torch.Tensor) else v)
                         for k, v in g.items() if k != "params"))
        for p in g["params"]:
            out.append(p.data_ptr())
            out.extend(v.data_ptr() for v in opt.state.get(p, {}).values()
                       if isinstance(v, torch.Tensor))
    return tuple(out)


class _Graph(NamedTuple):
    """One captured train step and its static tensors."""
    graph: Any              # torch.cuda.CUDAGraph
    fingerprint: tuple      # ``_fingerprint`` of the state it was taken on
    batch: ViewBatch        # the static inputs each call copies into
    loss: torch.Tensor      # [] the step's loss, rewritten by each replay
    aux: tuple              # (overflow bool[], num_rendered int64[])


class TrainStep:
    """``step(state, batch) -> (state, loss)``: one render, the loss, its
    five-gradient backward and one optimiser step on ``state.scene``;
    ``loss`` is detached and holds no gradient buffer.

    On the card (``mesh=None``, the binned path, ``capture=True``) the
    step is kept on the device as CUDA graphs (module docstring):
    ``captures`` and ``replays`` count the graphs taken and replayed. Each
    call is one optimiser step, so step n is the same step as JAX's step
    n. ``steps(state, batch, n)`` runs n of them with no host read in
    between (``make_train_loop``)."""

    def __init__(self, faces, bg, height: int, width: int, mesh=None,
                 force: str | None = None, kcap: int | None = None,
                 capture: bool = True):
        _check_mesh(mesh)
        self.faces, self.bg = faces, bg
        self.height, self.width = height, width
        self.mesh, self.force, self.kcap = mesh, force, kcap
        self.capture = capture
        self.captures = 0
        self.replays = 0
        self._consts: dict = {}   # device -> (faces, bg) on it
        self._streams: dict = {}  # device -> the side stream of captures
        self._warm: dict = {}     # shape key -> fingerprint after warm-up
        self._graphs: dict = {}   # shape key -> _Graph

    def __call__(self, state: TrainState, batch: ViewBatch):
        loss, _aux, replayed = self._run(state, batch, warn=True)
        return state, loss.clone() if replayed else loss

    def steps(self, state: TrainState, batch: ViewBatch,
              n: int) -> torch.Tensor:
        """``n`` steps on the same batch; returns the losses [n]. On the
        captured path the losses and the overflow flags are written into
        device tensors and read once at the end, which warns once if any
        step overflowed."""
        if not self._captured(state, batch):
            return torch.stack([self(state, batch)[1] for _ in range(n)])
        dev = state.scene.verts.device
        losses = torch.empty(n, dtype=torch.float32, device=dev)
        flags = torch.zeros(n, dtype=torch.bool, device=dev)
        totals = torch.zeros(n, dtype=torch.int64, device=dev)
        for i in range(n):
            loss, (overflow, total), _r = self._run(state, batch, warn=False)
            losses[i].copy_(loss)
            flags[i].copy_(overflow)
            totals[i].copy_(total)
        kcap = self.kcap
        if kcap is None:
            kcap = default_key_capacity(batch.mv_t.shape[0],
                                        self.faces.shape[0])
        warn_if_overflow(flags.any(), totals[flags.int().argmax()], kcap,
                         "render_tri_binned; raise "
                         "TriRenderSettings.key_capacity")
        return losses

    def _captured(self, state: TrainState, batch: ViewBatch) -> bool:
        """Whether this step runs as a CUDA graph: on the card, without a
        mesh, on the binned path."""
        scene = state.scene
        dev = scene.verts.device
        return (self.capture and self.mesh is None and dev.type == "cuda"
                and tri_strategy(scene.verts.shape[0], self.faces.shape[0],
                                 dev, self.force) == "binned")

    def _constants(self, dev):
        """``faces`` and ``bg`` on ``dev``, moved once (no host-to-device
        copy inside a captured step)."""
        c = self._consts.get(dev)
        if c is None:
            c = self._consts[dev] = (torch.as_tensor(self.faces).to(dev),
                                     torch.as_tensor(self.bg).to(dev))
        return c

    def _loss(self, scene: TriScene, batch: ViewBatch, warn: bool):
        """The loss and, on the binned path, its (overflow, num_rendered)."""
        faces, bg = self._constants(scene.verts.device)
        binned = tri_strategy(scene.verts.shape[0], faces.shape[0],
                              scene.verts.device, self.force) == "binned"
        out = render_views(scene, faces, batch, bg, self.height, self.width,
                           self.force, self.kcap, with_aux=binned,
                           warn_overflow=warn)
        loss = torch.mean((out[0] - batch.target) ** 2)
        return loss, out[2] if binned else None

    def _eager(self, state: TrainState, batch: ViewBatch, warn: bool):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss, aux = self._loss(state.scene, batch, warn)
        loss.backward()
        loss = loss.detach()
        if self.mesh is not None:
            loss = _sum_over_views(self.mesh, list(state.scene), [loss],
                                   lambda flat: self.mesh.size)
        opt.step()
        return loss, aux

    def _run(self, state: TrainState, batch: ViewBatch, warn: bool):
        """One step: (loss, aux, replayed). After a replay the loss and
        the aux are the graph's static tensors, which the next replay
        rewrites."""
        if not self._captured(state, batch):
            return (*self._eager(state, batch, warn), False)
        _require_capturable(state.opt_state)
        dev = state.scene.verts.device
        key = tuple((tuple(t.shape), t.dtype, t.device)
                    for t in (*state.scene, *batch))
        fp = _fingerprint(state)
        g = self._graphs.get(key)
        if g is None or g.fingerprint != fp:
            if self._warm.get(key) != fp:
                # an ordinary eager step, on the stream that will capture
                self._graphs.pop(key, None)
                side = self._side_stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    loss, aux = self._eager(state, batch, warn)
                torch.cuda.current_stream(dev).wait_stream(side)
                self._warm[key] = _fingerprint(state)
                return loss, aux, False
            g = self._graphs[key] = self._capture(state, batch, fp, dev)
        for static, t in zip(g.batch, batch):
            if static is not t:
                static.copy_(t)
        g.graph.replay()
        self.replays += 1
        return g.loss, g.aux, True

    def _side_stream(self, dev):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def _capture(self, state: TrainState, batch: ViewBatch, fp, dev):
        """Capture one whole step (PyTorch's whole-network recipe): the
        gradients are set to None first, so that the captured backward
        allocates them in the graph's memory pool."""
        static = ViewBatch(*(t.clone() for t in batch))
        state.opt_state.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._side_stream(dev)):
            loss, aux = self._eager(state, static, warn=False)
        self.captures += 1
        return _Graph(graph, fp, static, loss, aux)


def make_train_step(faces, bg, height: int, width: int, mesh=None,
                    force: str | None = None, kcap: int | None = None,
                    capture: bool = True) -> TrainStep:
    """``step(state, batch) -> (state, loss)``: one render, the loss, its
    five-gradient backward and one optimiser step on ``state.scene``.
    ``loss`` is detached.

    On the card (``mesh=None``, the binned path) the step is captured as
    a CUDA graph from its second call on and replayed (``TrainStep``; the
    optimiser must be capturable); ``capture=False`` keeps every step
    eager. With ``mesh``, ``batch`` is this rank's views: the loss is each
    rank's mean over its views, and the loss and the gradients are
    averaged over the ranks (JAX's ``pmean``) before the step."""
    return TrainStep(faces, bg, height, width, mesh=mesh, force=force,
                     kcap=kcap, capture=capture)


def make_train_loop(faces, bg, height: int, width: int, n_steps: int,
                    mesh=None, force: str | None = None,
                    kcap: int | None = None, capture: bool = True):
    """``loop(state, batch) -> (state, losses [n_steps])``: ``n_steps``
    train steps on the same batch. On the card (``mesh=None``, the binned
    path) the steps replay the captured step's graph with no host read in
    between (``TrainStep.steps``): the JAX package's ``lax.scan`` loop.
    ``loop.step`` is the ``TrainStep`` it runs."""
    step = make_train_step(faces, bg, height, width, mesh=mesh, force=force,
                           kcap=kcap, capture=capture)

    def loop(state: TrainState, batch: ViewBatch):
        return state, step.steps(state, batch, n_steps)

    loop.step = step
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
    """``step(state, batch) -> (state, loss)``: one render, the backward
    of the squared error, the loss and the gradients divided by
    ``max(count, 1)`` (the masked mean squared error, as JAX's
    ``_tet_normalize`` does it), and one optimiser step on
    ``state.scene``. ``loss`` is detached.

    With ``mesh``, ``batch`` is this rank's views, whose jitter (``seed`` >
    0) is keyed by their global view index; the squared error, the count
    and the gradients are summed over the ranks before the division by the
    global ``max(count, 1)`` (JAX's ``psum``): per-view active counts
    differ, so a mean of per-rank means would not be the global one."""
    _check_mesh(mesh)
    se_fn = make_tet_se_fn(geom, bg, height, width, seed)

    def step(state: TrainState, batch: TetViewBatch):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        offset = None if mesh is None else mesh.rank * batch.mv_t.shape[0]
        se, cnt = se_fn(state.scene, batch, offset)
        se.backward()
        loss = _sum_over_views(mesh, list(state.scene), [se, cnt],
                               lambda flat: torch.clamp_min(flat[-1], 1.0))
        opt.step()
        return state, loss

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
