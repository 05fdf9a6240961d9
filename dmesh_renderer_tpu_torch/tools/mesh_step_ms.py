"""Time the sharded (``mesh=``) train steps of both renderers, eager and as
CUDA graphs, over NCCL with one rank per card and one view per rank, at 1,
2 and 4 ranks: the multi-card twin of ``tri_step_ms`` and ``tet_step_ms``.

At a point of V ranks the tri problem is ``utils.scenes.tri_scene(100_000,
V, 800, 800)`` and the tet problem ``tet_scene(20, V, 800, 800)`` with ray
seed 3 (each rank's jitter keyed by its global view), Adam(1e-2,
capturable=True), zero background and target; ``parallel.shard_view_batch``
gives each rank its view. Each rank reports, for the eager sharded step
(``capture=False``) and the captured one (the default: a graph, or G1 and
G2, with the all-reduce inside):

- the median host ms of ``--reps`` synchronised steps after 2 warm-ups;
- the host syncs of one step (PyTorch's sync debug mode);
- the device busy ms of one step under ``torch.profiler``, its device
  events, the busy share (busy over the median) and the device ms of the
  all-reduce's NCCL events within the step;
- the peak device memory of one step above what was allocated before
  (a replay allocates nothing: its memory is the graphs' pool);
- the step's captures, replays and fallbacks;

then ``make_train_loop``/``make_tet_train_loop`` at ``--loop-steps`` steps
(ms per step, median of 3 loops), the all-reduce of the step's flat
buffer alone (CUDA events around 10 calls, and its device busy ms), the
rank's peak device memory over all of it (``max_memory_allocated``: the
scene, the optimisers, the eager steps' buffers and the graphs' pools),
and the bits: 3 eager and 3 captured sharded steps from fresh states,
whose parameters must be bitwise equal to each other (``bitwise``) and,
by the digest the output keeps of each rank, to every other rank's.

An NCCL kernel runs until every rank has joined it, so a rank's device
time of the all-reduce also holds its wait for the last rank: the
smallest over the ranks is the transfer's.

A point that asks for more ranks than there are cards is skipped, and the
output says so. ``--root`` imports the package from another checkout (by
default the one holding this script); the ranks inherit it. One host then
compares two versions in one call (parent, change, change, parent):

    python dmesh_renderer_tpu_torch/tools/mesh_step_ms.py [--root DIR] \\
        [--ranks 1 2 4] [--kinds tri tet] [--reps N] [--loop-steps N]

Run it by path (the ranks import this file as their main module). Prints
one JSON line. Needs the card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

TRI_FACES = 100_000
TET_GRID = 20
SIZE = 800
RAY_SEED = 3
TIMEOUT = 900.0  # seconds for one point's ranks


def problem(kind: str, views: int, dev):
    """The ``kind`` problem at ``views`` views on ``dev`` (module
    docstring): (fresh(mesh) -> TrainState, make_step(mesh, **kw),
    make_loop(n, mesh), batch, the scalars the step's flat buffer holds
    beside the gradients)."""
    import numpy as np
    import torch

    from dmesh_renderer_tpu_torch import parallel
    from dmesh_renderer_tpu_torch.api import _inverses
    from dmesh_renderer_tpu_torch.models import dmesh
    from dmesh_renderer_tpu_torch.utils.scenes import tet_scene, tri_scene

    bg = torch.zeros(3, device=dev)
    target = torch.zeros((views, 3, SIZE, SIZE), device=dev)
    if kind == "tri":
        user = [torch.from_numpy(x).to(dev)
                for x in tri_scene(TRI_FACES, views, SIZE, SIZE, 0)]
        leaves, scene_type, extra = ((user[0], user[2], user[3]),
                                     dmesh.TriScene, user[6:8])
        make_step = lambda mesh, **kw: dmesh.make_train_step(  # noqa: E731
            user[1], bg, SIZE, SIZE, mesh=mesh, **kw)
        make_loop = lambda n, mesh: dmesh.make_train_loop(  # noqa: E731
            user[1], bg, SIZE, SIZE, n, mesh=mesh)
        scalars = 1  # the loss
    else:
        user = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in tet_scene(TET_GRID, views, SIZE, SIZE)[:11]]
        leaves, scene_type, extra = ((user[2], user[3]), dmesh.TetScene,
                                     user[7:8])
        geom = dmesh.TetGeometry(user[0], user[1], *user[8:11])
        make_step = lambda mesh, **kw: dmesh.make_tet_train_step(  # noqa
            geom, bg, SIZE, SIZE, mesh=mesh, seed=RAY_SEED, **kw)
        make_loop = lambda n, mesh: dmesh.make_tet_train_loop(  # noqa: E731
            geom, bg, SIZE, SIZE, n, mesh=mesh, seed=RAY_SEED)
        scalars = 3  # the squared error, the count, the record flag
    mv_t = user[4].transpose(1, 2).contiguous()
    proj_t = user[5].transpose(1, 2).contiguous()
    batch_type = dmesh.ViewBatch if kind == "tri" else dmesh.TetViewBatch
    batch = batch_type(mv_t, proj_t, *_inverses(mv_t, proj_t), *extra,
                       target)

    def fresh(mesh):
        scene = scene_type(*(x.detach().clone().requires_grad_(True)
                             for x in leaves))
        scene = parallel.replicate_params(mesh, scene)
        return dmesh.init_train_state(scene, lambda p: torch.optim.Adam(
            p, lr=1e-2, capturable=True))

    return fresh, make_step, make_loop, batch, scalars


def profiled(fn, word: str):
    """(device busy ms, device events, device ms of the events whose name
    holds ``word``) of one ``fn()`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    named = sum(e.time_range.elapsed_us() for e in dev
                if word in e.name.lower())
    return busy / 1e3, len(dev), named / 1e3


def digest(tensors) -> str:
    """The bits of ``tensors``, hashed: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def measure_rank(mesh, kind: str, reps: int, loop_steps: int) -> dict:
    """This rank's numbers of ``kind`` (module docstring). Every rank of the
    mesh calls it with the same arguments: the steps and the all-reduces
    run in lockstep."""
    import torch

    from dmesh_renderer_tpu_torch import parallel
    from dmesh_renderer_tpu_torch.tools.tri_step_ms import (
        cuda_ms, host_syncs, median_ms, peak_mib)

    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    fresh, make_step, make_loop, batch, scalars = problem(kind, mesh.size,
                                                          dev)
    local = parallel.shard_view_batch(mesh, batch)
    out = {"rank": mesh.rank, "views": mesh.size,
           "local_views": int(local.mv_t.shape[0])}
    for name, kw in (("step_eager", {"capture": False}),
                     ("step_captured", {})):
        step = make_step(mesh, **kw)
        st = fresh(mesh)
        fn = lambda: step(st, local)  # noqa: E731
        ms = median_ms(fn, reps)
        busy, events, nccl = profiled(fn, "nccl")
        out[name] = {"ms": ms, "host_syncs": host_syncs(fn), "busy_ms": busy,
                     "device_events": events, "busy_share": busy / ms,
                     "nccl_device_ms": nccl, "peak_mib": peak_mib(fn),
                     "captures": step.captures, "replays": step.replays,
                     "fallbacks": step.fallbacks}
        del st, step
    loop = make_loop(loop_steps, mesh)
    st = fresh(mesh)
    loop(st, local)  # builds (and where it can, captures) the step
    out["loop_ms_per_step"] = median_ms(lambda: loop(st, local), 3,
                                        warmup=0) / loop_steps
    out["loop_captures"] = loop.step.captures
    n = sum(p.numel() for p in st.scene) + scalars
    flat = torch.ones(n, device=dev)
    reduce = lambda: parallel.all_reduce(mesh, flat)  # noqa: E731
    out["allreduce"] = {"values": n, "events_ms": cuda_ms(reduce),
                        "device_ms": profiled(reduce, "nccl")[0]}
    out["rank_peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    del loop, st
    bits = []
    for kw in ({"capture": False}, {}):
        step, st = make_step(mesh, **kw), fresh(mesh)
        for _ in range(3):
            st, _loss = step(st, local)
        bits.append(digest(st.scene))
    out["bitwise"] = bits[0] == bits[1]
    out["digest"] = bits[1]
    del step, st
    torch.cuda.empty_cache()
    return out


def rank_worker(kinds, reps, loop_steps):
    """One rank of a point: ``measure_rank`` for each kind."""
    from dmesh_renderer_tpu_torch import parallel

    mesh = parallel.make_view_mesh()
    return {kind: measure_rank(mesh, kind, reps, loop_steps)
            for kind in kinds}


def run(port_root: str, ranks=(1, 2, 4), kinds=("tri", "tet"), reps=20,
        loop_steps=20):
    sys.path.insert(0, str(Path(port_root).resolve()))
    import torch

    import dmesh_renderer_tpu_torch as port
    from dmesh_renderer_tpu_torch import kernels, parallel

    if not torch.cuda.is_available():
        raise RuntimeError("mesh_step_ms needs a CUDA device")
    cards = torch.cuda.device_count()
    kernels.build()  # once, before the ranks start
    out = {"package": str(Path(port.__file__).resolve().parent),
           "device": torch.cuda.get_device_name(0), "cards": cards,
           "power": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip().splitlines(),
           "torch": torch.__version__, "nccl": ".".join(
               map(str, torch.cuda.nccl.version())),
           "reps": reps, "loop_steps": loop_steps, "points": {}}
    for n in ranks:
        if n > cards:
            out["points"][str(n)] = {
                "skipped": f"{n} ranks need {n} cards; {cards} present"}
            print(f"mesh_step_ms: the {n}-rank point skipped: {cards} "
                  "card(s)", file=sys.stderr, flush=True)
            continue
        per_rank = parallel.spawn(rank_worker, n, (tuple(kinds), reps,
                                                   loop_steps),
                                  backend="nccl", timeout=TIMEOUT)
        point = out["points"][str(n)] = {kind: [r[kind] for r in per_rank]
                                         for kind in kinds}
        point["ranks_equal"] = {kind: len({r["digest"]
                                           for r in point[kind]}) == 1
                                for kind in kinds}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mesh_step_ms")
    ap.add_argument("--root",
                    default=str(Path(__file__).resolve().parents[2]),
                    help="import dmesh_renderer_tpu_torch from this "
                         "checkout (default: the one holding this script)")
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--kinds", nargs="+", choices=("tri", "tet"),
                    default=["tri", "tet"])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--loop-steps", type=int, default=20)
    a = ap.parse_args(argv)
    out = run(a.root, a.ranks, a.kinds, a.reps, a.loop_steps)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
