"""The pieces of a train driver (``drivers/train.py``): back-to-back steps
of the port's train step.

Set-up builds one step object with its optimiser state and drives it from
the seed through its first ``reference_steps`` steps (the first eager, the
second captured, the rest replays), each on another view of the pool,
keeping each step's loss, parameters and Adam moments for the comparison;
then ``warmup_s`` seconds of the window's own steps. The same object then
runs the window: steps on the pool's views in turn, the scene and the
optimiser's state put back to their start in place every ``reset_every``
steps (so that every run times the same steps of training: a scene
trained on for thousands of steps changes the time of a step by -10 % to
+15 %), a device synchronisation every ``sync_every`` steps, until
``--seconds`` have passed at such a boundary. ``train_step_ms`` is the
window's time over its steps. After the window the program is freed and
the plain reference follows the first steps from the program's state
(``refside.follow``).
"""

from __future__ import annotations

import time

import torch

from .program import TrainProgram


def prime(prog: TrainProgram, batches, n: int, run=None) -> dict:
    """The first ``n`` steps of ``prog``, one per batch (the first eager,
    the second captured, the rest replays): the trajectory the comparison
    reads ({"losses", "params", "m", "v"}, as ``refside.train`` gives
    one). Each step is a part of ``run``'s set-up."""
    m, v = prog.moments()
    out = {"losses": [], "params": [prog.params()], "m": [m], "v": [v]}
    for k in range(n):
        out["losses"].append(float(prog(batches[k % len(batches)])))
        out["params"].append(prog.params())
        m, v = prog.moments()
        out["m"].append(m)
        out["v"].append(v)
        if run is not None:
            run.sync()
            run.mark(f"step{k + 1}")
    return out


def steps(prog: TrainProgram, batches, n: int, reset_every: int) -> list:
    """``n`` steps of the window, the k-th on batch k: every
    ``reset_every`` steps the scene and the optimiser's state go back to
    their start first, so that every window, in every run, repeats the same
    steps of training from the seed's scene. Returns the losses."""
    out = []
    for k in range(n):
        if k % reset_every == 0:
            prog.reset()
        out.append(prog(batches[k % len(batches)]))
    return out


def window(prog: TrainProgram, batches, sync_every: int, reset_every: int,
           sync, done) -> tuple[int, float, int]:
    """Chunks of ``sync_every`` steps (a multiple of ``reset_every``), each
    ended by a synchronisation, until ``done(elapsed seconds)`` says so at
    one: (steps, elapsed seconds, steps whose loss is not finite)."""
    n = 0
    bad = torch.zeros((), dtype=torch.long, device=prog.scene.verts.device)
    sync()
    t0 = time.perf_counter()
    while True:
        chunk = steps(prog, batches, sync_every, reset_every)
        bad += (~torch.isfinite(torch.stack(chunk))).sum()
        sync()
        n += sync_every
        elapsed = time.perf_counter() - t0
        if done(elapsed):
            return n, elapsed, int(bad)


def warm_up(prog: TrainProgram, batches, tr: dict, sync, done=None) -> None:
    """The window's own steps for ``warmup_s`` seconds of set-up. The card
    runs a step about 10 % slower for its first 3-17 s under this load and
    then keeps the faster pace (``PERF.md``); every window starts after
    that."""
    seconds = float(tr["warmup_s"])
    window(prog, batches, int(tr["sync_every"]), int(tr["reset_every"]), sync,
           done or (lambda elapsed: elapsed >= seconds))
