"""Driver ``train``: a train mix on one card (``harness/train.py``), for a
tri or a tet configuration alike (``TrainProgram`` takes the renderer from
the configuration). A traffic file that names it sets ``view_pool``,
``views_per_step``, ``reset_every``, ``sync_every``, ``warmup_s``,
``trace_steps`` and ``reference_steps``.

Untraced, the window's time over its steps is ``train_step_ms``. Traced,
``trace_steps`` steps of the window run under ``torch.profiler`` (enough
for the traced window to span some hundreds of milliseconds of the host's
clock), and the parameters before each traced step are kept (from an
untraced pass over the same steps), so that the rooflines count each
step's work at its own parameters.
"""

from __future__ import annotations

import gc
import math

import torch

from harness import compare, devtrace, faults
from harness.program import TrainProgram, build_kernels
from harness.scenes import make_scene, make_views
from harness.train import prime, steps, warm_up, window


def _inputs_of_steps(prog: TrainProgram, batches, step_views, n: int,
                     reset_every: int) -> list:
    """(views, parameters before the step) of the first ``n`` steps of a
    window from a reset. The steps repeat with the period ``lcm(reset_every,
    views)`` (the same views from the same start), so the steps of one
    period are run to take them, and step k shares step k mod period's
    pair."""
    period = math.lcm(reset_every, len(step_views))
    pairs = []
    for k in range(min(n, period)):
        if k % reset_every == 0:
            prog.reset()
        pairs.append((step_views[k % len(step_views)], prog.params()))
        prog(batches[k % len(batches)])
    return [pairs[k % period] for k in range(n)]


def run(run) -> None:
    """The whole run of a one-card train cell into ``run``."""
    cfg, tr, dev = run.cfg, run.traffic, run.dev
    run.mark("import")
    if dev.type == "cuda":
        build_kernels()
    run.mark("build")
    faults.plant(run.fault)
    scene, gen = make_scene(cfg, run.seed, dev)
    pool = make_views(cfg, scene, gen, int(tr["view_pool"]), targets=True)
    run.sync()
    run.mark("inputs")
    per = int(tr["views_per_step"])
    step_views = [pool.take([(k * per + j) % pool.mv_t.shape[0]
                             for j in range(per)])
                  for k in range(pool.mv_t.shape[0] // per)]
    prog = TrainProgram(cfg, scene, mark=run.mark)
    batches = [prog.batch(v) for v in step_views]
    run.sync()
    run.mark("batches")
    n_ref = int(tr["reference_steps"])
    got = prime(prog, batches, n_ref, run)
    warm_up(prog, batches, tr, run.sync)
    run.mark("warm-up")
    run.setup_done()

    reset = int(tr["reset_every"])
    if run.trace:
        run.syncs_per_step = devtrace.host_syncs(
            lambda: [prog(b) for b in batches[:4]]) / 4.0
        n = int(tr["trace_steps"])
        run.trace_inputs = _inputs_of_steps(prog, batches, step_views, n,
                                            reset)
        run.sync()
        with devtrace.traced(dev) as summary:
            steps(prog, batches, n, reset)
        run.trace_summary, run.trace_units = summary, n
        run.attempted, run.failed = n, 0
    else:
        n, elapsed, bad = window(prog, batches, int(tr["sync_every"]), reset,
                                 run.sync, lambda e: e >= run.seconds)
        run.attempted, run.failed = n, bad
        run.metric("train_step_ms", elapsed * 1e3 / n, "ms")
    run.read_memory()
    del prog, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run.scene = scene
    run.compare(compare.train_followed(
        cfg, scene, got, [step_views[k % len(step_views)]
                          for k in range(n_ref)]))
