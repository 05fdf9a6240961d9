"""The sharded (``mesh=``) train steps and loops as CUDA graphs over NCCL,
on one card.

A view mesh of one rank over NCCL (``parallel.spawn(..., 1,
backend="nccl")``) is one whose all-reduce a graph can hold
(``parallel.graph_capturable``): its tri step is one graph and its tet step
G1 and G2, the all-reduce inside. At the small tri and tet scenes, 5
captured sharded steps and a 5-step loop against 5 eager sharded steps
(``capture=False``) and against 5 captured steps without a mesh, bit for
bit; a forced record overflow (``ops.tet.LOG_CAP`` 1) taken by the exact
fallback on every rank; the host syncs of a replayed step (tri 0, tet 1,
the summed flag); and a non-capturable optimiser refused.

``mesh_rank`` is also the worker of ``test_torch_gpu_nccl.py``'s runs on
two cards or more, where one rank forces the overflow and every rank must
fall back.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_mesh_graph.py
"""

import hashlib
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dmesh_renderer_tpu_torch import parallel
from dmesh_renderer_tpu_torch.models import dmesh
from dmesh_renderer_tpu_torch.ops import geometry
from dmesh_renderer_tpu_torch.ops import tet as pt
from dmesh_renderer_tpu_torch.utils.scenes import tet_scene, tri_scene

pytestmark = pytest.mark.gpu

H, W = 96, 80
STEPS = 5
RAY_SEED = 3  # jittered tet rays, keyed by each rank's global view index
SPAWN_TIMEOUT = 300.0  # seconds for each spawn


def digest(tensors):
    """The bits of ``tensors``, hashed: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def problem(kind, dev, views):
    """The small ``kind`` ("tri" or "tet") problem at ``views`` views on
    ``dev``: (fresh(mesh=None, capturable=True, sgd=False) -> TrainState,
    make_step(mesh=None, **kw), make_loop(n, mesh=None), batch). The
    optimiser is Adam(1e-2), or SGD(1e-2) with ``sgd``."""
    target = torch.rand((views, 3, H, W), generator=torch.Generator()
                        .manual_seed(5)).to(dev)
    if kind == "tri":
        v, f, vc, fo, mv, proj, vd, fi = [
            torch.from_numpy(x).to(dev) for x in tri_scene(600, views, H, W,
                                                           3)]
        leaves, scene_type = (v, vc, fo), dmesh.TriScene
        extra = (vd, fi)
        bg = torch.tensor([0.1, 0.2, 0.3], device=dev)

        def make_step(mesh=None, **kw):
            return dmesh.make_train_step(f, bg, H, W, mesh=mesh, **kw)

        def make_loop(n, mesh=None):
            return dmesh.make_train_loop(f, bg, H, W, n, mesh=mesh)
    else:
        arrs = tet_scene(5, views, H, W)
        user = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in arrs[:11]]
        bg = torch.from_numpy(arrs[11]).to(dev)
        mv, proj = user[4], user[5]
        leaves, scene_type = (user[2], user[3]), dmesh.TetScene
        extra = (user[7],)
        geom = dmesh.TetGeometry(user[0], user[1], *user[8:11])

        def make_step(mesh=None, **kw):
            return dmesh.make_tet_train_step(geom, bg, H, W, mesh=mesh,
                                             seed=RAY_SEED, **kw)

        def make_loop(n, mesh=None):
            return dmesh.make_tet_train_loop(geom, bg, H, W, n, mesh=mesh,
                                             seed=RAY_SEED)
    mv_t = mv.transpose(1, 2).contiguous()
    proj_t = proj.transpose(1, 2).contiguous()
    inv = geometry.inverse44(torch.stack([mv_t, proj_t]))
    batch_type = dmesh.ViewBatch if kind == "tri" else dmesh.TetViewBatch
    batch = batch_type(mv_t, proj_t, inv[0], inv[1], *extra, target)

    def fresh(mesh=None, capturable=True, sgd=False):
        scene = scene_type(*(x.clone().requires_grad_(True)
                             for x in leaves))
        if mesh is not None:
            scene = parallel.replicate_params(mesh, scene)
        if sgd:
            opt = lambda p: torch.optim.SGD(p, lr=1e-2)  # noqa: E731
        else:
            opt = lambda p: torch.optim.Adam(  # noqa: E731
                p, lr=1e-2, capturable=capturable)
        return dmesh.init_train_state(scene, opt)

    return fresh, make_step, make_loop, batch


def run_steps(step, state, batch, n):
    """``n`` steps: each step's loss and the digest of the parameters and
    gradients after it, and the step's counts."""
    losses, digests = [], []
    for _ in range(n):
        state, loss = step(state, batch)
        losses.append(float(loss))
        digests.append(digest([*state.scene,
                               *(p.grad for p in state.scene)]))
    return {"losses": losses, "digests": digests,
            "counts": [step.captures, step.replays, step.fallbacks]}


def syncs(fn):
    """Host syncs of ``fn()``: warnings of ``set_sync_debug_mode``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum(str(w.message).startswith("called a synchronizing")
               for w in rec)


def mesh_rank(overflow_rank=0):
    """One rank of an NCCL view mesh, one view per rank, for each of tri
    and tet: ``STEPS`` eager sharded steps, captured sharded steps, a loop
    and (world 1) captured steps without a mesh; the host syncs of a
    replayed step; an SGD step (for one process's comparison); a
    non-capturable optimiser's refusal; and for tet a record overflow
    forced on rank ``overflow_rank`` alone."""
    mesh = parallel.make_view_mesh()
    dev = mesh.device
    out = {"rank": mesh.rank, "size": mesh.size, "device": str(dev),
           "backend": dist.get_backend(mesh.group),
           "capturable": parallel.graph_capturable(mesh)}
    for kind in ("tri", "tet"):
        fresh, make_step, make_loop, batch = problem(kind, dev, mesh.size)
        local = parallel.shard_view_batch(mesh, batch)
        r = {"eager": run_steps(make_step(mesh, capture=False), fresh(mesh),
                                local, STEPS)}
        step = make_step(mesh)
        st = fresh(mesh)
        r["captured"] = run_steps(step, st, local, STEPS)
        r["replay_syncs"] = syncs(lambda: step(st, local))
        loop = make_loop(STEPS, mesh)
        sl, losses = loop(fresh(mesh), local)
        r["loop"] = {"losses": losses.tolist(),
                     "digest": digest([*sl.scene,
                                       *(p.grad for p in sl.scene)]),
                     "counts": [loop.step.captures, loop.step.replays]}
        if mesh.size == 1:
            r["single"] = run_steps(make_step(), fresh(), local, STEPS)
        st, loss = make_step(mesh, capture=False)(
            fresh(mesh, sgd=True), local)
        r["sgd"] = {"loss": float(loss),
                    "scene": [p.detach().cpu() for p in st.scene],
                    "grads": [p.grad.cpu() for p in st.scene]}
        try:
            make_step(mesh)(fresh(mesh, capturable=False), local)
            r["refused"] = ""
        except RuntimeError as e:
            r["refused"] = str(e)
        if kind == "tet":
            saved = pt.LOG_CAP
            if mesh.rank == overflow_rank:
                pt.LOG_CAP = 1  # one record a ray: every replay overflows
            try:
                r["forced"] = run_steps(make_step(mesh), fresh(mesh), local,
                                        4)
            finally:
                pt.LOG_CAP = saved
        out[kind] = r
    return out


@pytest.fixture(scope="module")
def one_rank():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return parallel.spawn(mesh_rank, 1, backend="nccl",
                          timeout=SPAWN_TIMEOUT)[0]


def check_rank(r, kind):
    """The checks every rank passes, on one card or more: captured sharded
    steps and the loop bitwise the eager sharded steps; one capture, the
    other steps replays (no fallback); the replayed step's host syncs; a
    non-capturable optimiser refused; for tet the forced overflow taken by
    the exact fallback on every step after the warm-up, bitwise the eager
    steps."""
    x = r[kind]
    want = x["eager"]
    assert x["captured"]["losses"] == want["losses"]
    assert x["captured"]["digests"] == want["digests"]
    assert x["captured"]["counts"] == [1, STEPS - 1, 0]
    assert x["eager"]["counts"] == [0, 0, 0]
    assert x["loop"]["losses"] == want["losses"]
    assert x["loop"]["digest"] == want["digests"][-1]
    assert x["loop"]["counts"] == [1, STEPS - 1]
    assert x["replay_syncs"] == (0 if kind == "tri" else 1)
    assert "capturable" in x["refused"]
    assert want["losses"][-1] < want["losses"][0]
    if kind == "tet":
        f = x["forced"]
        assert f["counts"] == [1, 0, 3]
        assert f["losses"] == want["losses"][:4]
        assert f["digests"] == want["digests"][:4]


@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_mesh_steps_captured_bitwise(one_rank, kind):
    """World 1 over NCCL: the mesh is capturable; captured sharded steps,
    the loop and the forced overflow as ``check_rank`` says; and the
    world-1 mesh's steps bitwise the captured steps without a mesh."""
    assert (one_rank["backend"], one_rank["capturable"]) == ("nccl", True)
    check_rank(one_rank, kind)
    x = one_rank[kind]
    assert x["single"]["losses"] == x["captured"]["losses"]
    assert x["single"]["digests"] == x["captured"]["digests"]
    assert x["single"]["counts"] == [1, STEPS - 1, 0]
