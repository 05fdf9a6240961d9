"""Readings that a train cell's limits are set from, on the card, in one
process: the program's numbers on many seeds (the lower readings) and the
control's on a few (``harness/control.py``: the upper readings). A state
left unchanged reads 1 by the measure and needs no run.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        --control-seeds 7 8 9

Prints one JSON line per reading and a summary line.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run as portbench_run  # noqa: E402


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _one_card(cfg, tr, seed, dev):
    """The program's numbers of one seed, as a run of the cell takes them."""
    from harness import compare
    from harness.program import TrainProgram
    from harness.scenes import make_scene, make_views
    from harness.train import prime

    scene, gen = make_scene(cfg, seed, dev)
    per, V = int(tr["views_per_step"]), int(tr["view_pool"])
    pool = make_views(cfg, scene, gen, V, targets=True)
    steps = [pool.take([(k * per + j) % V for j in range(per)])
             for k in range(V // per)]
    prog = TrainProgram(cfg, scene)
    n = int(tr["reference_steps"])
    got = prime(prog, [prog.batch(v) for v in steps], n)
    del prog
    _free()
    return compare.train_followed(cfg, scene, got, steps[:n])


def _control(cfg, tr, seed, dev):
    from harness import control
    from harness.scenes import make_scene, make_views

    scene, gen = make_scene(cfg, seed, dev)
    per, n = int(tr["views_per_step"]), int(tr["reference_steps"])
    pool = make_views(cfg, scene, gen, int(tr["view_pool"]) * per,
                      targets=True)
    steps = [pool.take(list(range(k * per, (k + 1) * per))) for k in range(n)]
    return {"control": control.train_numbers(cfg, scene, steps)}


def main(argv=None) -> None:
    portbench_run._env()
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    a = ap.parse_args(argv)
    import torch

    from harness import spec
    from harness.program import build_kernels

    bench = spec.load_benchmark(portbench_run.ROOT)
    w = spec.cell(bench, a.workload)
    cfg, tr = spec.config(bench, w["config"]), spec.traffic(w["traffic"])
    dev = torch.device("cuda")
    build_kernels()
    lows, highs = [], []
    for seed in a.seeds:
        t0 = time.perf_counter()
        nums = _one_card(cfg, tr, seed, dev)
        lows.append(nums)
        print(json.dumps({"seed": seed, "program": nums,
                          "s": time.perf_counter() - t0}), flush=True)
        _free()
    for seed in a.control_seeds:
        t0 = time.perf_counter()
        nums = _control(cfg, tr, seed, dev)
        highs.append(nums)
        print(json.dumps({"seed": seed, **nums,
                          "s": time.perf_counter() - t0}), flush=True)
        _free()
    summary = {}
    for k in (lows or [{}])[0]:
        summary[k] = {"program_max": max(x[k] for x in lows)}
    for kind in (highs or [{}])[0]:
        for k in highs[0][kind]:
            summary.setdefault(k, {})[f"{kind}_min"] = min(
                x[kind][k] for x in highs)
    print(json.dumps({"workload": a.workload, "summary": summary}),
          flush=True)


if __name__ == "__main__":
    main()
