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

On the card, the train steps and loops of both renderers are what the JAX
package's ``jax.jit(step)`` and ``jax.jit(lax.scan(...))`` are: programs
that run with no host work per op. The binned tri frame and the tet frame
have static shapes and read nothing on the host under capture
(``ops/tri_binned.py``, ``ops/tet.py``), so a step (``_CapturedStep``)
runs the first call for a batch shape as an ordinary eager step (which
also builds every lazily made table and the optimiser's state), captures
the second into CUDA graphs on a side stream and replays them, and replays
them on every later call, after copying the batch into the graphs' static
inputs. The tri step (``TrainStep``) is one graph: zero_grad, forward,
backward, ``opt.step()``. The tet step (``TetTrainStep``) is two, G1
(zero_grad, forward, backward) and G2 (``opt.step()``), with one read
between them: the backward's record overflow flag, set where K5's records
passed their static capacity (which the JAX package never drops, and
neither does an eager step); a flagged step drops G1's gradients and is
taken eagerly. The optimiser must be capturable (``torch.optim.Adam(...,
capturable=True)``); a step whose optimiser is not raises on the card. A
batch of other shapes captures graphs of its own, as ``jit`` retraces; an
optimiser whose state tensors were replaced (``opt.load_state_dict``, a
checkpoint restore) or a new optimiser takes an eager step and captures
again. The dense tri oracle and the CPU stay eager.

Multi-view training (``mesh=``, a ``parallel.make_view_mesh`` mesh): each
rank renders its own views (``parallel.shard_view_batch``) with its own copy
of the scene (``parallel.replicate_params``), runs backward, and the
gradients of the view-shared parameters and the loss pieces are summed over
the ranks by one all-reduce of one flat buffer per step, as the JAX
package's ``shard_map`` steps do with ``pmean`` (tri) and ``psum`` (tet).
Every rank then takes the same optimiser step on the same bits.

A mesh whose collective a graph can hold (``parallel.graph_capturable``:
NCCL, one rank per card) is captured as a step without one is: the
all-reduce sits inside the tri graph and inside G1, enqueued in the
capturing stream's order (torch's NCCL all-reduce joins its own stream to
the capture by events). The tet step's flag is one more scalar of the
flat buffer, so every rank reads the same sum and a step that overflowed
on any rank is redone eagerly on every rank, whose eager all-reduce they
all join. Each rank decides eager, capture or replay from the batch's
shapes and the state's fingerprint alone, which agree on every rank when
every rank passes the same kind of state (a restore happens on all ranks
together); the eager first call per batch shape also makes the NCCL
communicator, which must exist before a capture. A gloo mesh stays eager
on every step: its all-reduce runs on the host through a CPU copy, which
no graph can hold (ranks that share a card take gloo,
``parallel.default_backend``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..ops import tet as tet_ops
from ..ops.tet import render_tet_core
from ..ops.binning import default_key_capacity, warn_if_overflow
from ..ops.tri import render_tri_auto, tri_strategy
from ..parallel.sharding import ViewMesh, all_reduce, graph_capturable
from ..utils import spans


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
    mesh by one all-reduce (no collective without a mesh). The gradients
    and the first scalar (the loss) are then divided in place by
    ``denom(summed buffer)`` and the gradients go into ``.grad``. Returns
    the divided loss, copied out of the buffer so that it does not keep the
    gradients alive, and the sums of the other scalars (a view of the
    buffer). One collective of one buffer keeps the sum's order fixed,
    every rank's bits equal and the host cost of a step to one call."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [s.detach().reshape(1) for s in scalars])
    if mesh is not None:
        flat = all_reduce(mesh, flat)
    n = flat.numel() - len(scalars)
    flat[:n + 1].div_(denom(flat))
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    return flat[n].clone(), flat[n + 1:]


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


def _require_capturable(opt: torch.optim.Optimizer, builder: str) -> None:
    if not all(g.get("capturable", False) for g in opt.param_groups):
        raise RuntimeError(
            f"{builder}: on the card the train step is captured as CUDA "
            "graphs, which needs a capturable optimiser (e.g. "
            "torch.optim.Adam(params, capturable=True)); this "
            f"{type(opt).__name__} is not. Pass capture=False to keep every "
            "step eager.")


def _fingerprint(state: TrainState) -> tuple:
    """What a captured step bakes in besides the batch: the optimiser, its
    hyperparameters, the addresses of the scene's tensors and of the
    optimiser's state tensors, and the spans' switch (``spans.fingerprint``:
    a graph holds stage marks exactly when spans were on as it was taken,
    so turning them on or off takes an eager step and a capture again). A
    step keeps the optimiser that each fingerprint was taken of
    (``_Graph.opt``, ``_CapturedStep._warm``), so that no other object
    takes its id or its tensors' addresses: the fingerprint then changes
    exactly when the caller passes another optimiser or one whose state
    tensors were replaced, which on a mesh every rank does together."""
    opt = state.opt_state
    out = [id(opt), spans.fingerprint(), *(p.data_ptr() for p in state.scene)]
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
    graphs: tuple           # torch.cuda.CUDAGraph: the step, or G1 and G2
    fingerprint: tuple      # ``_fingerprint`` of the state it was taken on
    opt: Any                # that state's optimiser, kept (``_fingerprint``)
    batch: Any              # the static inputs each call copies into
    loss: torch.Tensor      # [] the step's loss, rewritten by each replay
    aux: tuple              # (overflow bool[], num_rendered int64[])
    flag: Any               # G1's record overflow flag, f32[] summed over
                            # the mesh (split steps), or None
    grads: tuple            # the gradients G1 writes and G2 reads


class _CapturedStep:
    """The capture machinery of both renderers' train steps (module
    docstring): ``step(state, batch) -> (state, loss)``, one optimiser step
    per call, so step n is the same step as JAX's step n; ``loss`` is
    detached and holds no gradient buffer. ``captures``, ``replays`` and
    ``fallbacks`` count the captures taken, the steps replayed and the
    split steps redone eagerly. ``steps(state, batch, n)`` runs n steps
    with the losses kept on the device and read once at the end.

    A subclass passes the host-given tensors (``consts``, moved to each
    device once) and gives ``_grads`` (zero_grad, the forward, the backward
    and the gradients' reduction over a mesh; a split step's also returns
    its overflow flag) and ``_captured`` (whether a step runs as
    graphs).

    Spans (``utils.diagnostics.enable_spans``; off by default): a step
    runs inside ``spans.in_step``, opens with the mark ``step.open``,
    closes ``step.grads`` after ``_grads`` and ``step.optimizer`` after
    ``opt.step()``; a split step's G2 opens with ``step.resume``. The ops
    mark the stages between (``utils/spans.py`` lists them). Captured, the
    marks are graph nodes, so each replay stamps its stages on the device's
    clock with no host work. ``_run`` keeps the host spans ``step.eager``,
    ``step.capture``, ``step.replay`` (the batch copies and the graph
    launches), ``step.flag_read`` and ``step.fallback``; with spans off it
    tests one boolean per span site."""

    builder = ""           # the public builder's name, for messages
    split = False          # G1 (gradients) and G2 (``opt.step()``)
    overflow_context = ""  # the overflow warning's context
    avg_tiles = 16         # ``default_key_capacity``'s tiles per face
    faces_at = 0           # the index of ``faces`` in the constants

    def __init__(self, consts: tuple, height: int, width: int, mesh,
                 kcap: int | None, capture: bool):
        _check_mesh(mesh)
        self.height, self.width = height, width
        self.mesh, self.kcap, self.capture = mesh, kcap, capture
        self.captures = 0
        self.replays = 0
        self.fallbacks = 0
        self._host_consts = consts
        self._consts: dict = {}   # device -> consts on it
        self._streams: dict = {}  # device -> the side stream of captures
        self._warm: dict = {}     # shape key -> (fingerprint, optimiser)
                                  # after the warm-up
        self._graphs: dict = {}   # shape key -> _Graph

    def __call__(self, state: TrainState, batch):
        loss, _aux, replayed = self._run(state, batch, warn=True)
        return state, loss.clone() if replayed else loss

    def steps(self, state: TrainState, batch, n: int) -> torch.Tensor:
        """``n`` steps on the same batch; returns the losses [n]. On the
        captured path the losses and the overflow flags are written into
        device tensors and read once at the end, which warns once if any
        step overflowed (a split step also reads its one flag per step)."""
        if not self._captured(state, batch):
            return torch.stack([self(state, batch)[1] for _ in range(n)])
        dev = state.scene[0].device
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
                                        len(self._host_consts[
                                            self.faces_at]),
                                        self.avg_tiles)
        warn_if_overflow(flags.any(), totals[flags.int().argmax()], kcap,
                         self.overflow_context)
        return losses

    def _constants(self, dev):
        """The host-given tensors on ``dev``, moved once (no host-to-device
        copy inside a captured step)."""
        c = self._consts.get(dev)
        if c is None:
            c = self._consts[dev] = tuple(torch.as_tensor(x).to(dev)
                                          for x in self._host_consts)
        return c

    def _marked_grads(self, state: TrainState, batch, warn: bool):
        """``_grads`` between the marks that open the step and close
        ``step.grads``."""
        spans.mark("step.open")
        out = self._grads(state, batch, warn)
        spans.mark("step.grads")
        return out

    def _marked_opt_step(self, state: TrainState, resume: bool) -> None:
        """``opt.step()``, closed by the mark ``step.optimizer`` (opened by
        ``step.resume`` in a split step's G2)."""
        if resume:
            spans.mark("step.resume")
        state.opt_state.step()
        spans.mark("step.optimizer")

    def _eager(self, state: TrainState, batch, warn: bool):
        with spans.in_step(state.scene[0].device):
            loss, aux, _flag = self._marked_grads(state, batch, warn)
            self._marked_opt_step(state, False)
        return loss, aux

    def _run(self, state: TrainState, batch, warn: bool):
        """One step: (loss, aux, replayed). After a replay the loss and
        the aux are the graph's static tensors, which the next replay
        rewrites."""
        dev = state.scene[0].device
        on = spans.enabled
        t0 = spans.host_ns() if on else 0
        if not self._captured(state, batch):
            out = (*self._eager(state, batch, warn), False)
            if on:
                spans.host_span("step.eager", t0, dev)
            return out
        _require_capturable(state.opt_state, self.builder)
        key = tuple((tuple(t.shape), t.dtype, t.device)
                    for t in (*state.scene, *batch))
        fp = _fingerprint(state)
        g = self._graphs.get(key)
        if g is None or g.fingerprint != fp:
            if self._warm.get(key, (None,))[0] != fp:
                # an ordinary eager step, on the stream that will capture
                # (on a mesh its all-reduce also makes the communicator
                # before any capture)
                self._graphs.pop(key, None)
                side = self._side_stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    loss, aux = self._eager(state, batch, warn)
                torch.cuda.current_stream(dev).wait_stream(side)
                self._warm[key] = (_fingerprint(state), state.opt_state)
                if on:
                    spans.host_span("step.eager", t0, dev)
                return loss, aux, False
            g = self._graphs[key] = self._capture(state, batch, fp, dev)
            if on:
                spans.host_span("step.capture", t0, dev)
                t0 = spans.host_ns()
        for static, t in zip(g.batch, batch):
            if static is not t:
                static.copy_(t)
        g.graphs[0].replay()
        if on:
            spans.replayed(dev)
        if g.flag is not None:
            t1 = spans.host_ns() if on else 0
            flagged = bool(g.flag)  # the split step's one host read (4 bytes)
            if on:
                spans.host_span("step.flag_read", t1, dev)
            if flagged:
                out = (*self._fallback(state, batch, g, warn), False)
                if on:
                    spans.host_span("step.fallback", t0, dev)
                return out
            g.graphs[1].replay()
        self.replays += 1
        if on:
            spans.host_span("step.replay", t0, dev)
        return g.loss, g.aux, True

    def _fallback(self, state: TrainState, batch, g: _Graph, warn: bool):
        """G1 flagged an overflow: its gradients are dropped and the step is
        taken eagerly (whose forward reads the totals and sizes what G1
        could not hold); the gradients then go back into G1's buffers, which
        G2 reads."""
        self.fallbacks += 1
        loss, aux = self._eager(state, batch, warn)
        with torch.no_grad():
            for p, static in zip(state.scene, g.grads):
                static.copy_(p.grad)
                p.grad = static
        return loss, aux

    def _graphable_mesh(self) -> bool:
        """No mesh, or one whose all-reduce a graph can hold (module
        docstring)."""
        return self.mesh is None or graph_capturable(self.mesh)

    def _side_stream(self, dev):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def _capture(self, state: TrainState, batch, fp, dev):
        """Capture one step (PyTorch's whole-network recipe): the gradients
        are set to None first, so that the captured backward allocates them
        in the graph's memory pool. A split step captures G1 (zero_grad,
        forward, backward) and then G2 (``opt.step()``, the optimiser's
        capturable state updated in place) in the same pool."""
        static = type(batch)(*(t.clone() for t in batch))
        state.opt_state.zero_grad(set_to_none=True)
        side = self._side_stream(dev)
        g1 = torch.cuda.CUDAGraph()
        flag, graphs = None, (g1,)
        with torch.cuda.graph(g1, stream=side), spans.in_step(dev):
            if self.split:
                loss, aux, flag = self._marked_grads(state, static,
                                                     warn=False)
            else:
                loss, aux = self._eager(state, static, warn=False)
        if self.split:
            g2 = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g2, pool=g1.pool(), stream=side), \
                    spans.in_step(dev):
                self._marked_opt_step(state, True)
            graphs = (g1, g2)
        self.captures += 1
        return _Graph(graphs, fp, state.opt_state, static, loss, aux, flag,
                      tuple(p.grad for p in state.scene))


class TrainStep(_CapturedStep):
    """The tri train step: one render, the loss, its five-gradient backward
    and one optimiser step on ``state.scene`` (``_CapturedStep``). On the
    card (no mesh or an NCCL one, the binned path, ``capture=True``) the
    whole step is one CUDA graph (module docstring)."""

    builder = "make_train_step"
    overflow_context = ("render_tri_binned; raise "
                        "TriRenderSettings.key_capacity")

    def __init__(self, faces, bg, height: int, width: int, mesh=None,
                 force: str | None = None, kcap: int | None = None,
                 capture: bool = True):
        super().__init__((faces, bg), height, width, mesh, kcap, capture)
        self.force = force

    def _captured(self, state: TrainState, batch: ViewBatch) -> bool:
        """Whether this step runs as a CUDA graph: on the card, without a
        mesh or with an NCCL one, on the binned path."""
        scene = state.scene
        dev = scene.verts.device
        return (self.capture and dev.type == "cuda" and self._graphable_mesh()
                and tri_strategy(scene.verts.shape[0],
                                 self._host_consts[0].shape[0], dev,
                                 self.force) == "binned")

    def _grads(self, state: TrainState, batch: ViewBatch, warn: bool):
        """zero_grad, the loss and its backward, the loss and the gradients
        averaged over a mesh: (loss, on the binned path its (overflow,
        num_rendered), None)."""
        state.opt_state.zero_grad(set_to_none=True)
        scene = state.scene
        faces, bg = self._constants(scene.verts.device)
        binned = tri_strategy(scene.verts.shape[0], faces.shape[0],
                              scene.verts.device, self.force) == "binned"
        out = render_views(scene, faces, batch, bg, self.height, self.width,
                           self.force, self.kcap, with_aux=binned,
                           warn_overflow=warn)
        loss = torch.mean((out[0] - batch.target) ** 2)
        loss.backward()
        loss = loss.detach()
        if self.mesh is not None:
            loss, _ = _sum_over_views(self.mesh, list(scene), [loss],
                                      lambda flat: self.mesh.size)
        return loss, out[2] if binned else None, None


def make_train_step(faces, bg, height: int, width: int, mesh=None,
                    force: str | None = None, kcap: int | None = None,
                    capture: bool = True) -> TrainStep:
    """``step(state, batch) -> (state, loss)``: one render, the loss, its
    five-gradient backward and one optimiser step on ``state.scene``.
    ``loss`` is detached.

    On the card (the binned path) the step is captured as a CUDA graph
    from its second call on and replayed (``TrainStep``; the optimiser must
    be capturable); ``capture=False`` keeps every step eager. With
    ``mesh``, ``batch`` is this rank's views: the loss is each rank's mean
    over its views, and the loss and the gradients are averaged over the
    ranks (JAX's ``pmean``) before the step. An NCCL mesh (one rank per
    card) is captured with its all-reduce inside the graph; a gloo mesh
    stays eager, because its all-reduce runs on the host (module
    docstring)."""
    return TrainStep(faces, bg, height, width, mesh=mesh, force=force,
                     kcap=kcap, capture=capture)


def make_train_loop(faces, bg, height: int, width: int, n_steps: int,
                    mesh=None, force: str | None = None,
                    kcap: int | None = None, capture: bool = True):
    """``loop(state, batch) -> (state, losses [n_steps])``: ``n_steps``
    train steps on the same batch. On the card (the binned path, no mesh or
    an NCCL one) the steps replay the captured step's graph with no host
    read in between (``TrainStep.steps``): the JAX package's ``lax.scan``
    loop. A gloo mesh's steps stay eager (``make_train_step``).
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
    jitter (``seed`` > 0) when the batch is one shard of more views.
    ``with_aux=True`` also returns the first hit's (overflow,
    num_rendered)."""
    def se_fn(scene: TetScene, batch: TetViewBatch, view_offset=None,
              with_aux: bool = False):
        color, _depth, active, aux = render_tet_core(
            geom.verts, geom.faces, scene.verts_color, scene.faces_opacity,
            batch.mv_t, batch.proj_t, batch.inv_mv_t, batch.inv_proj_t,
            batch.faces_intense, geom.tets, geom.face_tets, geom.tet_faces,
            bg, height, width, seed, with_aux=True, view_offset=view_offset)
        m = active[:, None].to(torch.float32)
        se = torch.sum(m * (color - batch.target) ** 2)
        return (se, torch.sum(m) * 3.0) + ((aux,) if with_aux else ())
    return se_fn


def init_tet_train_state(
        scene: TetScene,
        optimizer: Callable[[list], torch.optim.Optimizer]) -> TrainState:
    """A train state whose optimiser, ``optimizer(list(scene))``, updates
    the tet scene's tensors (leaves that require grad)."""
    return TrainState(scene, None, optimizer(list(scene)))


class TetTrainStep(_CapturedStep):
    """The tet train step: one render, the backward of the squared error,
    the loss and the gradients divided by ``max(count, 1)`` and one
    optimiser step (``make_tet_train_step``). On the card (no mesh or an
    NCCL one, ``capture=True``) the step is two CUDA graphs, G1 (zero_grad,
    forward, backward, the sum over the mesh) and G2 (``opt.step()``), with
    the backward's record overflow flag
    (``ops.tet.render_tet_backward.overflow``), summed over the mesh in the
    gradients' buffer, read between them: a set flag on any rank drops G1's
    gradients and takes the step eagerly on every rank, whose backward
    holds every record (``fallbacks`` counts such steps)."""

    builder = "make_tet_train_step"
    split = True
    overflow_context = tet_ops.FH_OVERFLOW_CONTEXT
    avg_tiles = 5
    faces_at = 1

    def __init__(self, geom: TetGeometry, bg, height: int, width: int,
                 mesh=None, seed: int = 0, capture: bool = True):
        super().__init__((*geom, bg), height, width, mesh, None, capture)
        self.seed = seed

    def _captured(self, state: TrainState, batch: TetViewBatch) -> bool:
        """Whether this step runs as CUDA graphs: on the card, without a
        mesh or with an NCCL one."""
        return (self.capture and self._graphable_mesh()
                and state.scene.verts_color.device.type == "cuda")

    def _grads(self, state: TrainState, batch: TetViewBatch, warn: bool):
        """zero_grad, the squared error's backward, and the loss and the
        gradients divided by the (global) ``max(count, 1)``: (loss, the first
        hit's (overflow, num_rendered), the backward's record overflow flag
        summed over the mesh as f32[]). The flag is the flat buffer's last
        scalar, after the squared error and the count, so that one
        all-reduce gives every rank the same sum (the sum of 0/1 values is
        exact in f32 up to 2^24 ranks). The tet forward warns on its own
        (``warn`` is unused)."""
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        *geom, bg = self._constants(state.scene.verts_color.device)
        offset = (None if self.mesh is None
                  else self.mesh.rank * batch.mv_t.shape[0])
        se_fn = make_tet_se_fn(TetGeometry(*geom), bg, self.height,
                               self.width, self.seed)
        se, cnt, aux = se_fn(state.scene, batch, offset, with_aux=True)
        tet_ops.render_tet_backward.overflow = None
        se.backward()
        flag = tet_ops.render_tet_backward.overflow  # None: empty geometry
        flag = se.new_zeros(()) if flag is None else flag.to(se.dtype)
        loss, sums = _sum_over_views(
            self.mesh, list(state.scene), [se, cnt, flag],
            lambda flat: torch.clamp_min(flat[-2], 1.0))
        return loss, aux, sums[1]


def make_tet_train_step(geom: TetGeometry, bg, height: int, width: int,
                        mesh=None, seed: int = 0,
                        capture: bool = True) -> TetTrainStep:
    """``step(state, batch) -> (state, loss)``: one render, the backward
    of the squared error, the loss and the gradients divided by
    ``max(count, 1)`` (the masked mean squared error, as JAX's
    ``_tet_normalize`` does it), and one optimiser step on
    ``state.scene``. ``loss`` is detached.

    On the card the step is kept on the device as two CUDA graphs from its
    second call on (``TetTrainStep``; the optimiser must be capturable);
    ``capture=False`` keeps every step eager.

    With ``mesh``, ``batch`` is this rank's views, whose jitter (``seed`` >
    0) is keyed by their global view index; the squared error, the count
    and the gradients are summed over the ranks before the division by the
    global ``max(count, 1)`` (JAX's ``psum``): per-view active counts
    differ, so a mean of per-rank means would not be the global one. An
    NCCL mesh (one rank per card) is captured with its all-reduce inside
    G1, and the record overflow flag is summed with the gradients, so that
    a step that overflowed on any rank is redone on every rank; a gloo mesh
    stays eager, because its all-reduce runs on the host (module
    docstring)."""
    return TetTrainStep(geom, bg, height, width, mesh=mesh, seed=seed,
                        capture=capture)


def make_tet_train_loop(geom: TetGeometry, bg, height: int, width: int,
                        n_steps: int, mesh=None, seed: int = 0,
                        capture: bool = True):
    """``loop(state, batch) -> (state, losses [n_steps])``: ``n_steps``
    tet train steps on the same batch. On the card (no mesh or an NCCL one)
    the steps replay the captured step's graphs with the losses kept on the
    device and read once at the end (``TetTrainStep.steps``; each step
    still reads its flag): the JAX package's ``lax.scan`` loop. A gloo
    mesh's steps stay eager (``make_tet_train_step``). ``loop.step`` is the
    ``TetTrainStep`` it runs."""
    step = make_tet_train_step(geom, bg, height, width, mesh=mesh, seed=seed,
                               capture=capture)

    def loop(state: TrainState, batch: TetViewBatch):
        return state, step.steps(state, batch, n_steps)

    loop.step = step
    return loop
