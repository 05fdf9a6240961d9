"""Observability: render statistics, health counters, stage timing, tracing,
and the train steps' program spans.

A port of the JAX package's ``utils/diagnostics.py``:

  * ``tri_render_stats``: the binning statistics of a tri scene (pairs
    emitted, key-capacity overflow, per-tile list sizes, culled faces), from
    the same ``binning.emit_and_sort`` the render runs;
  * ``tet_health``: the active-pixel fraction per view of the tet
    renderer's ``active`` mask (walk failures degrade pixels to inactive);
  * ``StageTimer``: stage timing that waits for the stage's work: CUDA
    events on the card, the host clock on the CPU;
  * ``trace``: a ``torch.profiler`` trace (CPU and, with a card, CUDA
    activity) written as a Chrome trace; ``device_busy_ms``, the device
    time a trace holds, and ``device_time_by_name``, that time by kernel
    (``device_time_by_stage``: by the stage of the train step that issued
    it, where the trace holds span marks);

and the port's own program spans (``utils/spans.py``), which see inside a
captured train step, where no Python runs and a profiler trace can name a
kernel but not the stage that launched it:

  * ``enable_spans(on=True)``: the switch, off by default. On, the train
    steps of ``models/dmesh.py`` (``make_train_step``,
    ``make_tet_train_step``, their loops, on one card or a mesh) mark each
    stage boundary with one tiny kernel, ``span_mark`` of
    ``csrc/spans.cu``, which appends (span id, step index, the device's
    ``%globaltimer`` ns, a counter) to a ring on the device of at least
    1,024 steps' marks (it wraps). The marks are captured into the step's
    graphs, so every replay stamps its stages with no host work; nothing
    is read until a report. On the CPU a mark stores the host clock.
    Turning the switch changes the steps' fingerprint: the next call takes
    an eager step and captures again, so a graph never keeps or lacks
    marks. Off, no graph holds a mark and nothing is allocated.
  * The stages, flat and back to back (each mark closes one): the tri
    step tri.project, tri.binning (counter tri.pairs, the emitted pairs),
    tri.prep (counter tri.runs, the binning's (face, tile-row) runs, with
    tri.runs.capacity, the run table's rows), tri.k1, step.loss, tri.k2
    (counter tri.walked, the records K2 wrote), tri.reduce, step.grads,
    step.optimizer; the tet step
    tet.first_hit (counter tet.fh_pairs), tet.tables, tet.k4, step.loss,
    tet.bwd_start (counter tet.records), tet.k5, tet.reduce, step.grads,
    then the wait for the flag read between its graphs, then
    step.optimizer. On a mesh step.grads holds the all-reduce.
  * ``span_report(last_steps=None)``: reads the ring once and returns, for
    the last n complete steps, each stage's count and device ms (mean and
    total), the counters (each step's value and their max), the device's
    gaps between a step's graphs and between steps (each with the host
    span open at its start), the host spans (``step.eager``,
    ``step.capture``, ``step.replay``, ``step.flag_read``,
    ``step.fallback``, ``kernels.build``), the clock offset and its drift,
    and, given the step object, its captures, replays and fallbacks.
    Device stamps are put on the host clock that ``torch.profiler`` stamps
    its events with (``profiler_clock`` names it), so the stages line up
    with a trace.
    A training run can log it every N steps: a report costs one read of
    the ring (a synchronize) and a clock sample, and the ring keeps the
    last 1,024 steps.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
import torch

from ..api import resolve_device
from ..ops.binning import default_key_capacity, emit_and_sort
from ..ops.geometry import preprocess_faces, project_verts
from . import spans
from .config import BIN_TILE


def enable_spans(on: bool = True) -> None:
    """Turn the train steps' program spans on (the ring of the current
    device allocated and the clock offset measured) or off (every ring and
    host span freed). Module docstring."""
    spans.enable(on)


def span_report(last_steps: int | None = None, step=None) -> dict:
    """The program spans of the last ``last_steps`` complete train steps
    (all that the ring holds with None), read from the ring once; {} while
    spans are off. ``step``: a train step object whose ``captures``,
    ``replays`` and ``fallbacks`` to report (left out without it).
    ``utils.spans.report`` lists the keys."""
    return spans.report(last_steps, step)


def profiler_clock(samples: int = 8, slack_ns: int = 100_000) -> str | None:
    """The host clock that ``torch.profiler`` stamps its events with, found
    by bracketing ``record_function`` ranges with each candidate's reads
    (within ``slack_ns``, for the profiler's rounding): "CLOCK_REALTIME" or
    "CLOCK_MONOTONIC", or None if neither holds every range.
    ``utils.spans`` puts device stamps on ``spans.HOST_CLOCK``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    clocks = {"CLOCK_REALTIME": time.time_ns,
              "CLOCK_MONOTONIC": time.monotonic_ns}
    reads = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(samples):
            before = {k: f() for k, f in clocks.items()}
            with record_function(f"profiler_clock_{i}"):
                pass
            reads.append((before, {k: f() for k, f in clocks.items()}))
    base = prof.profiler.kineto_results.trace_start_ns()
    ev = {e.name: e for e in prof.events()}
    for name in clocks:
        if all(before[name] - slack_ns <= base + ev[f"profiler_clock_{i}"]
               .time_range.start * 1000 <= after[name] + slack_ns
               for i, (before, after) in enumerate(reads)):
            return name
    return None


def _mean_f32(x, dim=None):
    """The f32 mean as the JAX package takes it: the sum times the f32
    reciprocal of the count (XLA turns a divide by a constant count into
    that multiply), so the statistics equal the JAX package's bit for bit.
    The sums here are of small integers, exact in f32."""
    x = x.to(torch.float32)
    n = x.numel() if dim is None else math.prod(x.shape[d] for d in dim)
    total = x.sum() if dim is None else x.sum(dim=dim)
    return total * (torch.tensor(1.0) / n)


def tri_render_stats(verts, faces, mv_t, proj_t, height, width,
                     tile: int | None = None,
                     kcap: int | None = None) -> dict:
    """Binning statistics for a tri scene (mv_t, proj_t [B, 4, 4]
    transposed): num_rendered (pairs emitted), key_capacity, overflow, the
    tile count, per-tile list size mean and max, and the fraction of culled
    (view, face) pairs. ``tile`` defaults to the binned render's tile
    (``BIN_TILE``), with the same exact-coverage emission, so the counts
    are what the render builds."""
    tile = BIN_TILE if tile is None else tile
    B = mv_t.shape[0]
    gx = (width + tile - 1) // tile
    gy = (height + tile - 1) // tile
    if kcap is None:
        kcap = default_key_capacity(B, faces.shape[0])
    ndc, img = project_verts(verts, mv_t, proj_t, width, height)
    pre = preprocess_faces(ndc, img, faces, width, height, tile, tile)
    keys = emit_and_sort(pre, gx, gy, kcap, tile_px=tile)
    counts = keys.ends - keys.starts
    return {
        "num_rendered": int(keys.total),
        "key_capacity": int(kcap),
        "overflow": bool(keys.overflow),
        "tiles": int(counts.shape[0]),
        "tile_count_mean": float(_mean_f32(counts)),
        "tile_count_max": int(counts.max()),
        "culled_fraction": float(1.0 - _mean_f32(pre["valid"])),
    }


def tet_health(active) -> dict:
    """Health counters from the tet renderer's active mask ([B, H, W]
    bool): the active fraction per view and overall, and the inactive
    pixels (background misses and walk failures)."""
    active = torch.as_tensor(active)
    frac = _mean_f32(active, dim=(1, 2))
    return {
        "active_fraction_per_view": [float(x) for x in frac],
        "active_fraction": float(_mean_f32(frac)),
        "inactive_pixels": int((~active).sum()),
    }


class StageTimer:
    """Stage timing: ``with timer.stage("binning"): ...``.

    On ``cuda`` (the default) each stage is timed with CUDA events on the
    current stream and waits at its end for all of the stream's work, so
    the stage's outputs are ready, as the JAX package's timer blocks on
    them; on ``cpu`` with the host clock, where torch ops are done when
    they return. Times accumulate per name, in seconds."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt

    def summary(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k}: {v * 1000:.2f} ms" for k, v in self.times.items()]
        lines.append(f"total: {total * 1000:.2f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block, CPU activity and, where a
    card is present, CUDA activity; written to
    ``<log_dir>/trace_<pid>_<n>.json`` (Chrome trace format) at its end.
    Yields the profiler; its ``trace_path`` is set once the block ends."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.monotonic_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_time_by_name(prof) -> dict:
    """{name: (count, ms)} of a finished trace's device events (kernels,
    copies, fills), the largest total first."""
    acc: dict[str, list] = {}
    for e in _device_events(prof):
        a = acc.setdefault(e.name, [0, 0.0])
        a[0] += 1
        a[1] += e.time_range.elapsed_us() / 1e3
    return {k: (c, ms) for k, (c, ms) in
            sorted(acc.items(), key=lambda kv: -kv[1][1])}


def device_time_by_stage(prof, report: dict) -> dict:
    """{stage: {name: (count, ms)}} of a finished ``trace`` of whole train
    steps taken with spans on, and ``span_report`` of the same steps: each
    device event goes to the stage that the next mark kernel on the
    device's timeline closes, the trace's k-th mark kernel being the
    report's k-th mark, so that no clocks are compared. Events before a
    step's open mark go under "between steps", before a split step's
    ``step.resume`` under "between graphs", after the last mark under
    "after the last step". Raises if the trace and the report hold
    different numbers of marks."""
    marks = [n for row in report["per_step"] for n, _t, _c in row["marks"]]
    events = sorted(_device_events(prof), key=lambda e: e.time_range.start)
    seen = sum(spans.MARK_KERNEL in e.name for e in events)
    if seen != len(marks):
        raise ValueError(f"device_time_by_stage: {seen} mark kernels in the "
                         f"trace, {len(marks)} marks in the report")
    names = {spans.OPEN_STEP: "between steps",
             spans.RESUME: "between graphs"}
    out: dict = {}
    k = 0
    for e in events:
        if spans.MARK_KERNEL in e.name:
            k += 1
            continue
        stage = (names.get(marks[k], marks[k]) if k < len(marks)
                 else "after the last step")
        a = out.setdefault(stage, {}).setdefault(e.name, [0, 0.0])
        a[0] += 1
        a[1] += e.time_range.elapsed_us() / 1e3
    return {st: {k: (c, ms) for k, (c, ms) in
                 sorted(d.items(), key=lambda kv: -kv[1][1])}
            for st, d in out.items()}


def device_busy_ms(prof) -> float:
    """The device time of a finished ``trace``: the union of the intervals
    of its device events (kernels, copies, fills), in ms."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in _device_events(prof))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3
