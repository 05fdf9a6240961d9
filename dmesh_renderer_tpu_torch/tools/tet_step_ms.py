"""Time the tet serving frame, train step and train loop, eager and as CUDA
graphs, at the tet headline (``utils.scenes.tet_scene(20, 1, 800, 800)``,
Adam(1e-2, capturable=True), zero background and target): the tet twin of
``tri_step_ms``.

For each of: the eager serving frame (``TetRenderer`` without gradients),
the captured serving frame (the caller's ``torch.cuda.graph`` around the
same call), the eager train step (``make_tet_train_step(...,
capture=False)``), the captured train step (its default: two graphs with
one flag read between them) and ``make_tet_train_loop`` at
``--loop-steps`` steps, it reports ``tri_step_ms.measure``'s numbers: the
median host ms of ``--reps`` synchronised calls after the warm-ups (the
loop: per step, of 3 loops), the host syncs of one call, the device busy ms
and device events of one call under ``torch.profiler``, the busy share, and
the peak device memory of one call.

Then the stages that static capacities changed: the first hit's bbox
emission (``emit_and_sort(sort_by="min_depth")``), the record CSR
(``segment_csr`` of K5's keys) and the whole record reduce
(``reduce_tet_records``), each by its device busy ms under the profiler
(and the emission's sort kernels alone) and by CUDA events around 10 calls;
with the pair count, the key capacity, the records and the record
capacity.

``--stages`` reports instead the captured train step's device time by
stage (``tri_step_ms.stage_kernels``).

``--root`` imports the package from another checkout (by default the one
holding this script); a package without captured tet steps reports the
eager numbers only. One card then compares two versions in one call
(parent, change, change, parent):

    python dmesh_renderer_tpu_torch/tools/tet_step_ms.py [--root DIR] \\
        [--reps N] [--loop-steps N] [--grid G] [--size S] [--views B] \\
        [--stages]

Prints one JSON line. Needs the card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path


def stage_times(fargs, H, W):
    """The bbox emission, the record CSR and the record reduce at the
    inputs' forward, with an all-ones upstream gradient: device busy ms,
    device events, CUDA-event ms, and the emission's sort kernels' ms."""
    import torch

    from dmesh_renderer_tpu_torch.ops import binning, geometry
    from dmesh_renderer_tpu_torch.ops import reduce as rd
    from dmesh_renderer_tpu_torch.ops import tet as pt
    from dmesh_renderer_tpu_torch.tools.tri_step_ms import cuda_ms, profiled

    B, F, P = fargs[4].shape[0], fargs[1].shape[0], fargs[0].shape[0]
    kcap = binning.default_key_capacity(B, F, avg_tiles_per_face=5)
    ndc, img = geometry.project_verts(fargs[0], fargs[4], fargs[5], W, H)
    pre = geometry.preprocess_faces(ndc, img, fargs[1], W, H, 32, 32)
    gx, gy = (W + 31) // 32, (H + 31) // 32
    emit = lambda: binning.emit_and_sort(pre, gx, gy, kcap,
                                         sort_by="min_depth")
    keys_fh = emit()
    _c, _d, _a, saved = pt.render_tet_forward(*fargs, H, W, 0)
    ones = (torch.ones((B, 3, H, W), device=fargs[0].device),
            torch.ones((B, 1, H, W), device=fargs[0].device))
    st = pt.bwd_start_state(saved, fargs[10], *ones, fargs[12])
    m = saved["march"]
    keys, rec, _bad = pt.bwd_march(saved["ray_d"], saved["cam_o"],
                                   saved["zw"], *st[:4], m["tet_geo"],
                                   m["tet_nrm"], m["tet_ids"], m["shade"],
                                   H * W)
    # a static capacity keeps the rows past the records out of the CSR by
    # their key F; before it, the buffers held the records alone and the
    # reduce took F + 1 segments
    n_seg = F if len(st) > 4 else F + 1
    out = {"pairs": int(keys_fh.total), "key_capacity": kcap,
           "key_slots": int(keys_fh.slot_face.numel()),
           "records": int(st[0][3].long().sum()), "record_rows": st[3],
           "record_bytes": int(rec.numel() * 4 + keys.numel() * 4)}
    for name, fn in (
            ("bbox_emission", emit),
            ("record_csr", lambda: rd.segment_csr(keys, n_seg)),
            ("record_reduce", lambda: pt.reduce_tet_records(
                keys, rec, fargs[1], P))):
        fn()
        busy, events, sort_ms = profiled(fn)
        out[f"{name}_device_ms"] = busy
        out[f"{name}_device_events"] = events
        out[f"{name}_events_ms"] = cuda_ms(fn)
        if name == "bbox_emission":
            out["bbox_emission_sort_kernels_ms"] = sort_ms
    return out


def run(port_root: str, reps: int, loop_steps: int, grid: int, S: int,
        views: int = 1, stages: bool = False):
    sys.path.insert(0, str(Path(port_root).resolve()))
    import numpy as np
    import torch

    import dmesh_renderer_tpu_torch as port
    from dmesh_renderer_tpu_torch.api import _inverses
    from dmesh_renderer_tpu_torch.models import dmesh
    from dmesh_renderer_tpu_torch.tools.tri_step_ms import (
        measure, median_ms, stage_kernels)
    from dmesh_renderer_tpu_torch.utils.scenes import tet_scene

    if not torch.cuda.is_available():
        raise RuntimeError("tet_step_ms needs a CUDA device")
    dev = torch.device("cuda")
    arrs = tet_scene(grid, views, S, S)
    user = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in arrs[:11]]
    bg = torch.zeros(3, device=dev)
    mv_t = user[4].transpose(1, 2).contiguous()
    proj_t = user[5].transpose(1, 2).contiguous()
    fargs = (user[0], user[1], user[2], user[3], mv_t, proj_t,
             *_inverses(mv_t, proj_t), user[7], user[8], user[9], user[10],
             bg)
    renderer = port.TetRenderer(port.TetRenderSettings(S, S, bg), "cuda")
    captures = "capture" in inspect.signature(
        dmesh.make_tet_train_step).parameters
    out = {"package": str(Path(port.__file__).resolve().parent),
           "device": torch.cuda.get_device_name(0),
           "power": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "reps": reps, "size": S, "grid": grid, "views": views,
           "tet_faces": int(user[1].shape[0]),
           "captured_steps": captures}

    geom = dmesh.TetGeometry(user[0], user[1], *user[8:11])
    batch = dmesh.TetViewBatch(*fargs[4:9], torch.zeros((views, 3, S, S),
                                                        device=dev))

    def fresh():
        scene = dmesh.TetScene(*(x.detach().clone().requires_grad_(True)
                                 for x in (user[2], user[3])))
        return dmesh.init_tet_train_state(scene, lambda p: torch.optim.Adam(
            p, lr=1e-2, capturable=True))

    if stages:
        out["by_stage"] = stage_kernels(
            dmesh.make_tet_train_step(geom, bg, S, S), fresh(), batch)
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
        step = dmesh.make_tet_train_step(geom, bg, S, S, **kw)
        st = fresh()
        out[name] = measure(lambda: step(st, batch), reps)
        losses = [float(step(st, batch)[1]) for _ in range(2)]
        assert all(np.isfinite(losses)), losses
        out[name]["fallbacks"] = getattr(step, "fallbacks", 0)

    loop = dmesh.make_tet_train_loop(geom, bg, S, S, loop_steps)
    st = fresh()
    loop(st, batch)  # builds (and on the card captures) the step
    out["loop_ms_per_step"] = median_ms(lambda: loop(st, batch), 3,
                                        warmup=0) / loop_steps
    out["loop_steps"] = loop_steps
    out["stages"] = stage_times(fargs, S, S)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tet_step_ms")
    ap.add_argument("--root",
                    default=str(Path(__file__).resolve().parents[2]),
                    help="import dmesh_renderer_tpu_torch from this "
                         "checkout (default: the one holding this script)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--loop-steps", type=int, default=20)
    ap.add_argument("--grid", type=int, default=20)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--views", type=int, default=1)
    ap.add_argument("--stages", action="store_true",
                    help="the captured train step by stage, alone")
    a = ap.parse_args(argv)
    out = run(a.root, a.reps, a.loop_steps, a.grid, a.size, a.views,
              a.stages)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
