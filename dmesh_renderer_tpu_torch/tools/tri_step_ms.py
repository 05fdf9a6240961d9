"""Time the tri serving frame, train step and train loop, eager and as CUDA
graphs, at the tri headline (``utils.scenes.tri_scene(100_000, 1, 800,
800)``, Adam(1e-2, capturable=True), zero background and target).

For each of: the eager serving frame (``TriRenderer`` without gradients),
the captured serving frame (the caller's ``torch.cuda.graph`` around the
same call), the eager train step (``make_train_step(..., capture=False)``),
the captured train step (its default) and ``make_train_loop`` at
``--loop-steps`` steps, it reports:

- the median host ms of ``--reps`` synchronised calls after the warm-ups
  (the loop: per step, of 3 loops);
- the host syncs of one call (PyTorch's sync debug mode);
- the device busy ms of one call (the union of its device events under
  ``torch.profiler``), its device events, and the busy share (busy over the
  median);
- the peak device memory of one call above what was allocated before it.

Then the stages that static capacities changed: the binning
(``emit_and_sort``), the record CSR (``segment_csr`` of the records'
segment ids) and the whole record reduce (``records_to_faces``), each by
its device busy ms under the profiler (and the binning's sort kernels
alone) and by CUDA events around 10 calls, which also holds the time the
device waits for the host to issue the stage's many small launches.

``--stages`` reports instead the captured train step's device time by
stage (``stage_kernels``): the step's program spans on, each stage's device
ms a step and its largest kernels.

``--root`` imports the package from another checkout (by default the one
holding this script); a package without captured steps reports the eager
numbers only. One card then compares two versions in one call (parent,
change, change, parent):

    python dmesh_renderer_tpu_torch/tools/tri_step_ms.py [--root DIR] \\
        [--reps N] [--loop-steps N] [--tri-faces F] [--size S] [--stages]

Prints one JSON line. Needs the card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

WARMUP = 2


def _sync():
    import torch

    torch.cuda.synchronize()


def median_ms(fn, reps, warmup=WARMUP):
    """Median host ms of ``reps`` calls, each ended by a device
    synchronisation, after ``warmup`` calls."""
    import numpy as np

    for _ in range(warmup):
        fn()
    _sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def host_syncs(fn):
    """The host syncs of one ``fn()`` as the sync debug mode reports them
    (the first call of ``set_sync_debug_mode`` also warns that the mode is
    a prototype: that notice is not a sync)."""
    import torch

    _sync()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    _sync()
    return sum(str(w.message).startswith("called a synchronizing")
               for w in seen)


def profiled(fn):
    """(device busy ms, device events, ms of the sort kernels) of one
    ``fn()`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    sort_ms = sum(e.time_range.elapsed_us() for e in dev
                  if "sort" in e.name.lower()) / 1e3
    return busy / 1e3, len(dev), sort_ms


def peak_mib(fn):
    """Peak device memory of one ``fn()`` above what was allocated before."""
    import torch

    _sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    _sync()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def cuda_ms(fn, reps=10, warmup=2):
    """Mean ms of ``fn()`` between CUDA events over ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    _sync()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    _sync()
    return a.elapsed_time(b) / reps


def measure(fn, reps, warmup=WARMUP):
    """The numbers of one kind of call (module docstring)."""
    ms = median_ms(fn, reps, warmup)
    busy, events, _sort = profiled(fn)
    return {"ms": ms, "host_syncs": host_syncs(fn), "busy_ms": busy,
            "device_events": events, "busy_share": busy / ms,
            "peak_mib": peak_mib(fn)}


def stage_kernels(step, state, batch, steps=16, warm=8, top=6):
    """The train step ``step`` by stage, with the program's spans on
    (``utils.diagnostics.enable_spans``): ``warm`` steps from ``state`` on
    ``batch`` (eager, capture, replays), then ``steps`` replays under
    ``torch.profiler``. Each stage's device ms a step (its marks) and its
    ``top`` largest kernels (launches and ms a step, placed by the mark
    kernels around them, ``diagnostics.device_time_by_stage``), the waits
    between graphs and between steps, the counters, and the step's
    replays and fallbacks. Spans are off again after it."""
    from torch.profiler import ProfilerActivity, profile

    from dmesh_renderer_tpu_torch.utils import diagnostics

    diagnostics.enable_spans()
    try:
        for _ in range(warm):
            state, _loss = step(state, batch)
        _sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                state, _loss = step(state, batch)
            _sync()
        rep = diagnostics.span_report(steps, step=step)
        by_stage = diagnostics.device_time_by_stage(prof, rep)
    finally:
        diagnostics.enable_spans(False)
    n = rep["steps"]
    stages = {}
    for name in [*rep["stages"], *(k for k in by_stage
                                   if k not in rep["stages"])]:
        kernels = by_stage.get(name, {})
        item = rep["stages"].get(name)
        stages[name] = {
            "ms": item["total_ms"] / n if item else None,
            "kernel_ms": sum(ms for _c, ms in kernels.values()) / n,
            "top": [[k, c / n, ms / n]
                    for k, (c, ms) in list(kernels.items())[:top]]}
    return {"steps": n, "stages": stages,
            "gaps": {k: v["mean_ms"] for k, v in rep["gaps"].items()},
            "counters": {k: v["max"] for k, v in rep["counters"].items()},
            "replays": rep["replays"], "fallbacks": rep["fallbacks"]}


def stage_times(fargs, H, W):
    """The binning, the record CSR and the record reduce at the headline's
    inputs: device busy ms, CUDA-event ms, and the binning's sort kernels'
    ms."""
    import torch

    from dmesh_renderer_tpu_torch.ops import binning, geometry
    from dmesh_renderer_tpu_torch.ops import reduce as rd
    from dmesh_renderer_tpu_torch.ops import tri_binned as tb

    (verts, faces, vc, fo, mv_t, proj_t, inv_mv, inv_proj, vd, fi,
     bg) = fargs
    B, F = mv_t.shape[0], faces.shape[0]
    kcap = binning.default_key_capacity(B, F)
    ndc, img = geometry.project_verts(verts, mv_t, proj_t, W, H)
    pre = geometry.preprocess_faces(ndc, img, faces, W, H, 32, 32)
    gx, gy = (W + 31) // 32, (H + 31) // 32
    emit = lambda: binning.emit_and_sort(pre, gx, gy, kcap, tile_px=32)
    _c, _d, keys, inputs, state = tb._forward(*fargs, H, W, kcap, None)
    gin = torch.ones((B, 5, H, W), device=verts.device)
    rec, ids = tb.bwd_composite(*inputs[:6], *state, gin, B, H, W)
    if hasattr(tb, "record_segments"):
        seg = tb.record_segments(ids, keys.slot_face, B * F)
    else:
        seg = keys.slot_face[ids]
    out = {"sort_keys": int(keys.slot_face.numel()),
           "record_csr_ids": int(seg.numel()),
           "record_bytes": int(rec.numel() * 4)}
    for name, fn in (
            ("binning", emit),
            ("record_csr", lambda: rd.segment_csr(seg, B * F, inner=4)),
            ("record_reduce", lambda: tb.records_to_faces(
                rec, ids, keys.slot_face, keys.sigma, inputs[3], fi))):
        fn()
        busy, events, sort_ms = profiled(fn)
        out[f"{name}_device_ms"] = busy
        out[f"{name}_device_events"] = events
        out[f"{name}_events_ms"] = cuda_ms(fn)
        if name == "binning":
            out["binning_sort_kernels_ms"] = sort_ms
    return out


def run(port_root: str, reps: int, loop_steps: int, n_tris: int, S: int,
        stages: bool = False):
    sys.path.insert(0, str(Path(port_root).resolve()))
    import numpy as np
    import torch

    import dmesh_renderer_tpu_torch as port
    from dmesh_renderer_tpu_torch.api import _inverses
    from dmesh_renderer_tpu_torch.models import dmesh
    from dmesh_renderer_tpu_torch.utils.scenes import tri_scene

    if not torch.cuda.is_available():
        raise RuntimeError("tri_step_ms needs a CUDA device")
    dev = torch.device("cuda")
    user = [torch.from_numpy(x).to(dev)
            for x in tri_scene(n_tris, 1, S, S, 0)]
    bg = torch.zeros(3, device=dev)
    mv_t = user[4].transpose(1, 2).contiguous()
    proj_t = user[5].transpose(1, 2).contiguous()
    fargs = (user[0], user[1], user[2], user[3], mv_t, proj_t,
             *_inverses(mv_t, proj_t), user[6], user[7], bg)
    renderer = port.TriRenderer(port.TriRenderSettings(S, S, bg), "cuda")
    captures = "capture" in inspect.signature(
        dmesh.make_train_step).parameters
    out = {"package": str(Path(port.__file__).resolve().parent),
           "device": torch.cuda.get_device_name(0),
           "power": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "reps": reps, "size": S, "tri_faces": n_tris,
           "captured_steps": captures}

    batch = dmesh.ViewBatch(*fargs[4:10], torch.zeros((1, 3, S, S),
                                                      device=dev))

    def fresh():
        scene = dmesh.TriScene(*(x.detach().clone().requires_grad_(True)
                                 for x in (user[0], user[2], user[3])))
        return dmesh.init_train_state(scene, lambda p: torch.optim.Adam(
            p, lr=1e-2, capturable=True))

    if stages:
        out["by_stage"] = stage_kernels(
            dmesh.make_train_step(user[1], bg, S, S), fresh(), batch)
        return out

    def frame():
        with torch.no_grad():
            return renderer(*user)

    out["serve_eager"] = measure(frame, reps)
    if captures:
        frame()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            frame()
        out["serve_captured"] = measure(g.replay, reps)

    kinds = [("step_eager", {"capture": False} if captures else {})]
    if captures:
        kinds.append(("step_captured", {}))
    for name, kw in kinds:
        step = dmesh.make_train_step(user[1], bg, S, S, **kw)
        st = fresh()
        out[name] = measure(lambda: step(st, batch), reps)
        losses = [float(step(st, batch)[1]) for _ in range(2)]
        assert all(np.isfinite(losses)), losses

    loop = dmesh.make_train_loop(user[1], bg, S, S, loop_steps)
    st = fresh()
    loop(st, batch)  # builds (and on the card captures) the step
    out["loop_ms_per_step"] = median_ms(lambda: loop(st, batch), 3,
                                        warmup=0) / loop_steps
    out["loop_steps"] = loop_steps
    out["stages"] = stage_times(fargs, S, S)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tri_step_ms")
    ap.add_argument("--root",
                    default=str(Path(__file__).resolve().parents[2]),
                    help="import dmesh_renderer_tpu_torch from this "
                         "checkout (default: the one holding this script)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--loop-steps", type=int, default=20)
    ap.add_argument("--tri-faces", type=int, default=100_000)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--stages", action="store_true",
                    help="the captured train step by stage, alone")
    a = ap.parse_args(argv)
    out = run(a.root, a.reps, a.loop_steps, a.tri_faces, a.size, a.stages)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
