"""Multi-view sharding over a ``torch.distributed`` process group.

The counterpart of the JAX package's ``parallel/sharding.py``. The
reference's only large-scale parallel axis is the multi-view batch B: every
CUDA kernel carries a batch index, and the gradients of the view-shared
parameters (verts, verts_color, faces_opacity) are summed across views by
atomicAdd (cuda_rasterizer/backward.cu:389-418).

In torch a "device mesh" is a process group with one rank per view shard
(``ViewMesh``). Each rank holds its own slice of the views and its own copy
of the view-shared parameters, renders and back-propagates its views alone
(binning them with its own key capacity), and the train step
(``models/dmesh.py``, ``mesh=``) sums the shared parameters' gradients over
the group with one all-reduce of a flat buffer: the collective counterpart
of the reference's cross-view atomicAdd.

JAX's ``view_sharding(mesh)`` and ``replicated(mesh)`` are GSPMD placement
descriptors that ``jax.device_put`` and ``jit`` read. A torch rank has no
global array to place: it simply holds its slice or its copy. So
``shard_view_batch`` takes the role of ``device_put(batch,
view_sharding(mesh))`` (it returns this rank's views) and
``replicate_params`` that of ``device_put(params, replicated(mesh))`` (it
broadcasts rank 0's values to every rank); the descriptors themselves have
no counterpart.

A key-capacity overflow is per rank, as it is per device under JAX's
``shard_map``: reduce the flag of ``render_tri_auto(..., with_aux=True)``
with ``all_reduce(mesh, x, dist.ReduceOp.MAX)`` to see it on every rank.

Over gloo, the collectives here copy a CUDA tensor to the CPU and back:
gloo's collectives run on the host, and NCCL will not put two ranks on one
card, so ranks that share a card use gloo (``launch.default_backend``).
Over NCCL (one rank per card) they run in place on the card tensor, with no
host copy and no host read, so a CUDA graph can capture them
(``graph_capturable``); the train steps of ``models/dmesh.py`` then capture
the all-reduce with the rest of the step.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

VIEW_AXIS = "views"  # the mesh's one axis; names the group a mesh creates


class ViewMesh(NamedTuple):
    """A 1-D mesh over the ``views`` axis: a process group, this process's
    rank in it, its size, and the device that holds this rank's views."""
    group: Any  # torch.distributed.ProcessGroup
    rank: int
    size: int
    device: torch.device


def make_view_mesh(n_devices: int | None = None, group=None,
                   device=None) -> ViewMesh | None:
    """A view mesh over the ranks of ``group`` (default: every rank), or over
    its first ``n_devices`` ranks. Every rank of ``group`` must call it
    (a smaller mesh is a new group, which every rank creates); a rank
    outside the first ``n_devices`` gets None. ``device`` defaults to
    ``cuda:{rank % torch.cuda.device_count()}``; pass "cpu" to run on the
    CPU."""
    from ..api import resolve_device

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_view_mesh: torch.distributed is not initialised; call "
            "torch.distributed.init_process_group on every rank first (or "
            "start the ranks with parallel.spawn)")
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if n_devices is not None:
        if n_devices > size:
            # a silently truncated mesh would halve (or worse) the view
            # parallelism the caller sized capacities/memory for
            raise ValueError(
                f"make_view_mesh: requested {n_devices} devices but only "
                f"{size} are available")
        if n_devices < 1:
            raise ValueError(
                f"make_view_mesh: requested {n_devices} devices; a mesh "
                "needs at least 1")
        if n_devices < size:
            sub = dist.new_group(dist.get_process_group_ranks(group)[
                :n_devices], group_desc=VIEW_AXIS)
            if dist.get_rank(group) >= n_devices:
                return None
            group, size = sub, n_devices
    rank = dist.get_rank(group)
    if device is None:
        resolve_device("cuda")
        device = torch.device("cuda", dist.get_rank()
                              % torch.cuda.device_count())
    device = resolve_device(device)
    if device.type == "cuda" and device.index is not None:
        # NCCL and the kernels' launches take the current device
        torch.cuda.set_device(device)
    return ViewMesh(group, rank, size, device)


def graph_capturable(mesh: ViewMesh) -> bool:
    """Whether a CUDA graph can capture this mesh's collectives: the mesh's
    device is a card and its group's backend is NCCL, whose collectives are
    device work on the card tensor. gloo's run on the host (a CUDA tensor
    goes through a CPU copy), which no graph can hold."""
    return (mesh.device.type == "cuda"
            and dist.get_backend(mesh.group) == "nccl")


def _host_collective(mesh: ViewMesh, tensor: torch.Tensor, collective):
    """``collective(t)`` on ``tensor`` in place; over gloo a CUDA tensor
    goes through a CPU copy."""
    if tensor.is_cuda and dist.get_backend(mesh.group) == "gloo":
        host = tensor.cpu()
        collective(host)
        return tensor.copy_(host)
    collective(tensor)
    return tensor


def all_reduce(mesh: ViewMesh, tensor: torch.Tensor,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``tensor`` reduced over the mesh (in place, and returned): every rank
    ends with the same bits."""
    return _host_collective(
        mesh, tensor, lambda t: dist.all_reduce(t, op=op, group=mesh.group))


def barrier(mesh: ViewMesh) -> None:
    """Wait until every rank of the mesh reaches this point (an all-reduce
    of one value on the mesh's device, which either backend takes)."""
    all_reduce(mesh, torch.zeros(1, device=mesh.device))


def _map(fn, tree):
    """``fn`` applied to every leaf of a (Named)tuple tree; None stays
    None."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        out = [_map(fn, x) for x in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree)


def shard_view_batch(mesh: ViewMesh, batch):
    """This rank's views of ``batch`` (a (Named)tuple of tensors or arrays
    whose leading axis is the views): rows ``[rank * b, (rank + 1) * b)`` of
    every leaf, b = views / mesh size, on the mesh's device, in the batch's
    own type."""
    n = mesh.size
    leaves = []
    _map(leaves.append, batch)
    for leaf in leaves:
        if leaf.shape[0] % n != 0:
            raise ValueError(
                f"shard_view_batch: {leaf.shape[0]} views do not divide "
                f"evenly over the {n}-device mesh; pad the view batch or "
                f"build the mesh with make_view_mesh(n_devices=<divisor>)")

    def local(x):
        b = x.shape[0] // n
        x = torch.as_tensor(x)[mesh.rank * b:(mesh.rank + 1) * b]
        return x.to(mesh.device).contiguous()

    return _map(local, batch)


def replicate_params(mesh: ViewMesh, params):
    """Every tensor of ``params`` (a (Named)tuple tree) copied onto the
    mesh's device and broadcast from the mesh's rank 0, so that every rank
    starts bitwise equal; each copy is a leaf that requires grad where the
    input did."""
    src = dist.get_global_rank(mesh.group, 0)

    def rep(x):
        t = torch.as_tensor(x).detach().to(mesh.device, copy=True)
        t = _host_collective(mesh, t.contiguous(), lambda h: dist.broadcast(
            h, src=src, group=mesh.group))
        return t.requires_grad_(x.requires_grad
                                if isinstance(x, torch.Tensor) else False)

    return _map(rep, params)
