"""Time the serving frame of both renderers through the public API.

One frame is a forward of ``TriRenderer`` or ``TetRenderer`` without
gradients, at the headline scenes by default
(``utils.scenes.tri_scene(100_000, 1, 800, 800)`` and
``tet_scene(20, 1, 800, 800)``). For each renderer it reports:

- the median host ms of ``--reps`` frames, each ended by a device
  synchronisation, after 2 warm-ups;
- the host syncs one frame makes, as PyTorch's sync debug mode reports
  them (on the card only);
- for the tet frame, its active pixels.

``--root`` imports the package from another checkout (by default the one
holding this script). One card can then time two versions with this one
script:

    python dmesh_renderer_tpu_torch/tools/serve_frame_ms.py [--root DIR] \\
        [--device {cuda,cpu}] [--reps N] [--tri-faces F] [--tet-grid N] \\
        [--size S]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from pathlib import Path

WARMUP = 2


def _frame_stats(frame, dev, reps):
    """(median ms over ``reps`` synchronised frames after ``WARMUP``, the
    host syncs of one frame or None off the card)."""
    import numpy as np
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(WARMUP):
        frame()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        frame()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    syncs = None
    if dev.type == "cuda":
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                frame()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sync()
        # the first call of set_sync_debug_mode also warns that the mode
        # is a prototype; only the syncs count
        syncs = sum(str(w.message).startswith("called a synchronizing")
                    for w in seen)
    return float(np.median(times)), syncs


def main(argv=None):
    ap = argparse.ArgumentParser(prog="serve_frame_ms")
    ap.add_argument("--root",
                    default=str(Path(__file__).resolve().parents[2]),
                    help="import dmesh_renderer_tpu_torch from this "
                         "checkout (default: the one holding this script)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tri-faces", type=int, default=100_000)
    ap.add_argument("--tet-grid", type=int, default=20)
    ap.add_argument("--size", type=int, default=800)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(Path(a.root).resolve()))
    import numpy as np
    import torch

    import dmesh_renderer_tpu_torch as port
    from dmesh_renderer_tpu_torch.api import resolve_device
    from dmesh_renderer_tpu_torch.utils.scenes import tet_scene, tri_scene

    dev = resolve_device(a.device)
    S = a.size
    tri_user = [torch.from_numpy(x).to(dev)
                for x in tri_scene(a.tri_faces, 1, S, S, 0)]
    tri = port.TriRenderer(port.TriRenderSettings(
        S, S, np.array([0.1, 0.1, 0.1], np.float32)), device=dev)
    *tet_arrays, tet_bg = tet_scene(a.tet_grid, 1, S, S)
    tet_user = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in tet_arrays]
    tet = port.TetRenderer(port.TetRenderSettings(S, S, tet_bg), device=dev)

    def tri_frame():
        with torch.no_grad():
            return tri(*tri_user)

    def tet_frame():
        with torch.no_grad():
            return tet(*tet_user)

    tri_ms, tri_syncs = _frame_stats(tri_frame, dev, a.reps)
    tet_ms, tet_syncs = _frame_stats(tet_frame, dev, a.reps)
    out = {"package": str(Path(port.__file__).resolve().parent),
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "reps": a.reps, "warmup": WARMUP, "size": S,
           "tri_faces": int(tri_user[1].shape[0]),
           "tet_faces": int(tet_user[1].shape[0]),
           "tri_frame_ms": tri_ms, "tri_syncs": tri_syncs,
           "tet_frame_ms": tet_ms, "tet_syncs": tet_syncs,
           "tet_active": int(tet_frame()[2].sum())}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
