"""Program spans of the train steps: stage marks on the device's clock,
inside the captured graphs, and host spans beside them.

``utils/diagnostics.py`` re-exports the switch and the report
(``enable_spans``, ``span_report``); this module is apart from it because
the ops (``ops/tri_binned.py``, ``ops/tet.py``) and ``kernels.py`` call
``mark`` and ``host_span``, and ``diagnostics.py`` imports the ops.

The mark. ``mark(name, counter=None)`` appends one record to a ring:
(span id, step index, the clock in ns, counter value). On the card it
launches ``span_mark`` (``csrc/spans.cu``), one thread that reads
``%globaltimer`` and takes its slot with an atomic add on the ring's head,
on the current stream: inside a capture the mark becomes a graph node, and
every replay appends that replay's records. ``counter`` is an optional
0-d device tensor that the mark reads (a pair or record total; 0 without
one). On the CPU a mark stores the host clock, ops being done when they
return. A mark does something only while spans are on and a step object is
inside a step (``in_step``): a frame rendered outside a train step leaves
no record.

The stages. Each mark closes the stage before it and is named after it;
``step.open`` (which adds 1 to the device's step index) and
``step.resume`` (the start of the tet step's second graph) open without
closing one. Stages are flat and back to back, so every kernel of a step
lies in one stage:

  tri step (one graph): tri.project, tri.binning (counter tri.pairs),
  tri.prep, tri.k1, step.loss, tri.k2 (counter tri.walked), tri.reduce,
  step.grads, step.optimizer;
  tet step (G1, the flag read, G2): tet.first_hit (counter tet.fh_pairs),
  tet.tables, tet.k4, step.loss, tet.bwd_start (counter tet.records),
  tet.k5, tet.reduce, step.grads | step.resume | step.optimizer.

The time from ``step.grads`` to ``step.resume`` is the device's wait
between the tet step's graphs (the flag read); the time from one step's
``step.optimizer`` to the next step's ``step.open`` is its wait between
steps (the host's loop and replay launch, and what the caller runs between
steps).

Host spans (name, step index, start, end) come from the step object's
``_run`` (``step.eager``, ``step.capture``, ``step.replay``,
``step.flag_read``, ``step.fallback``) and from ``kernels.load``/``build``
(``kernels.build``), kept in memory. The host clock is CLOCK_REALTIME
(``time.time_ns``): the clock ``torch.profiler`` stamps its events with
(``diagnostics.profiler_clock`` checks it). Device stamps go onto it by an
offset measured when spans are turned on and again at each report (a mark
launched right after a synchronize, bracketed by host reads; the report's
own sample sets the offset, and with the first it gives the drift), so
the stages, the host spans and a profiler trace share one timeline (a
trace's own GPU times may sit some us off it: ``torch.profiler``
converts them by session).

The switch is off by default. Off, nothing is marked or allocated, and the
train steps capture the same graphs as without this module; the
fingerprint of a captured step holds ``fingerprint()``, so turning spans on
or off makes the next call an eager step and a capture again.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

# every mark's name; its id is its index
MARKS = ("step.open", "step.resume",
         "tri.project", "tri.binning", "tri.prep", "tri.k1", "step.loss",
         "tri.k2", "tri.reduce",
         "tet.first_hit", "tet.tables", "tet.k4", "tet.bwd_start", "tet.k5",
         "tet.reduce",
         "step.grads", "step.optimizer")
_ID = {n: i for i, n in enumerate(MARKS)}
OPEN_STEP, RESUME, CLOSE_STEP = "step.open", "step.resume", "step.optimizer"
# the counter each stage's closing mark carries
COUNTERS = {"tri.binning": "tri.pairs", "tri.k2": "tri.walked",
            "tet.first_hit": "tet.fh_pairs", "tet.bwd_start": "tet.records"}
TRI_STAGES = ("tri.project", "tri.binning", "tri.prep", "tri.k1",
              "step.loss", "tri.k2", "tri.reduce", "step.grads",
              "step.optimizer")
TET_STAGES = ("tet.first_hit", "tet.tables", "tet.k4", "step.loss",
              "tet.bwd_start", "tet.k5", "tet.reduce", "step.grads",
              "step.optimizer")
STEPS_KEPT = 1024         # the ring holds at least this many steps' marks
MARKS_PER_STEP = 16       # room for a step's marks (tri 10, tet 11)
RING_ROWS = STEPS_KEPT * MARKS_PER_STEP
HOST_SPANS_KEPT = 8 * STEPS_KEPT
MARK_KERNEL = "span_mark_kernel"  # the mark's kernel, as a trace names it
HOST_CLOCK = "CLOCK_REALTIME"
DRIFT_AFTER_NS = 30 * 10 ** 9  # clock samples this far apart give a drift
host_ns = time.time_ns
_CTYPES = {torch.int32: 1, torch.int64: 2}  # the counters' dtypes
_SETUP = ("kernels.build", "step.eager", "step.capture")

enabled = False        # the switch (``enable``)
_generation = 0        # counts the times spans were turned on
_depth = 0             # > 0 while a step object is inside a step
_dev = None            # that step's device
_last = None           # the device of the last step opened
_rings: dict = {}      # device -> _Ring
_host: collections.deque = collections.deque(maxlen=HOST_SPANS_KEPT)


class _Ring:
    """The marks of one device: on the card [RING_ROWS, 4] int64 rows and
    the state (head, step index) on the device, with a one-row ring of the
    clock samples; on the CPU a list. ``step`` mirrors the device's step
    index on the host (each step opened outside a capture, and each replay
    of a graph holding an open mark, adds 1)."""

    def __init__(self, dev: torch.device):
        self.dev, self.step, self.head = dev, 0, 0
        self.clock: list = []  # the first and the newest clock samples
        if dev.type == "cuda":
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("spans: the ring of a device is made "
                                   "before a capture (its first step is "
                                   "eager)")
            z = lambda *s: torch.zeros(s, dtype=torch.int64, device=dev)
            self.rows, self.state = z(RING_ROWS, 4), z(2)
            self.clock_row, self.clock_state = z(1, 4), z(2)
            self.clock.append(_clock_sample(self))
        else:
            self.rows = [None] * RING_ROWS

    def read(self) -> list:
        """The records, oldest first: (id, step, ns, counter)."""
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            head = int(self.state[0])
            rows = [tuple(r) for r in self.rows.cpu().tolist()]
        else:
            head, rows = self.head, self.rows
        if head <= RING_ROWS:
            return list(rows[:head])
        k = head % RING_ROWS
        return list(rows[k:]) + list(rows[:k])


def _launch(ring: _Ring, rows, state, counter, cap: int, span: int,
            open_step: bool, ctype: int) -> None:
    from .. import kernels

    kernels.launch("spans", "span_mark", [rows, state, counter],
                   [cap, span, int(open_step), ctype], ring.dev)


def _clock_sample(ring: _Ring, tries: int = 20) -> dict:
    """One reading of the offset between the host clock and the device's:
    a mark launched right after a synchronize, bracketed by host reads;
    the tightest bracket of ``tries``."""
    best = None
    for _ in range(tries):
        torch.cuda.synchronize(ring.dev)
        a = host_ns()
        _launch(ring, ring.clock_row, ring.clock_state, ring.clock_state, 1,
                -1, False, 0)
        torch.cuda.synchronize(ring.dev)
        b = host_ns()
        d = int(ring.clock_row[0, 2])
        if best is None or b - a < best[1] - best[0]:
            best = (a, b, d)
    a, b, d = best
    return {"host_ns": (a + b) // 2, "device_ns": d, "bracket_ns": b - a}


def _ring(dev: torch.device) -> _Ring:
    r = _rings.get(dev)
    if r is None:
        r = _rings[dev] = _Ring(dev)
    return r


def _device_of(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def enable(on: bool = True) -> None:
    """Turn spans on (allocating the ring of the current device: the
    current card where there is one, else the CPU) or off (freeing every
    ring and host span)."""
    global enabled, _generation, _last
    if on and not enabled:
        _generation += 1
        enabled = True
        _last = _device_of("cuda" if torch.cuda.is_available() else "cpu")
        _ring(_last)
    elif not on and enabled:
        enabled = False
        _rings.clear()
        _host.clear()
        _last = None


def fingerprint():
    """What a captured graph bakes in of the spans: None while off, else
    the switch's generation (the rings it writes to)."""
    return _generation if enabled else None


@contextlib.contextmanager
def in_step(dev):
    """The block is (part of) a step of a train step on ``dev``: marks
    record while spans are on."""
    global _depth, _dev
    if not enabled:
        yield
        return
    prev = _dev
    _depth, _dev = _depth + 1, _device_of(dev)
    try:
        yield
    finally:
        _depth, _dev = _depth - 1, prev


def mark(name: str, counter: torch.Tensor | None = None) -> None:
    """Close the stage ``name`` (or open a step: ``step.open``,
    ``step.resume``), reading ``counter`` where given; nothing unless
    spans are on inside a step (module docstring)."""
    global _last
    if not _depth:
        return
    ring = _ring(_dev)
    sid, open_step = _ID[name], name == OPEN_STEP
    if ring.dev.type == "cpu":
        if open_step:
            ring.step += 1
        value = 0 if counter is None else int(counter)
        ring.rows[ring.head % RING_ROWS] = (sid, ring.step, host_ns(), value)
        ring.head += 1
    else:
        if counter is None:
            ctr, ctype = ring.state, 0
        else:
            ctr = counter.detach()
            if ctr.dtype not in _CTYPES:
                ctr = ctr.to(torch.int64)
            ctr, ctype = ctr.contiguous(), _CTYPES[ctr.dtype]
        _launch(ring, ring.rows, ring.state, ctr, RING_ROWS, sid, open_step,
                ctype)
        if open_step and not torch.cuda.is_current_stream_capturing():
            ring.step += 1
    if open_step:
        _last = ring.dev


def replayed(dev) -> None:
    """A graph holding a step's open mark was replayed on ``dev``."""
    _ring(_device_of(dev)).step += 1


def host_span(name: str, start: int, dev=None) -> None:
    """Keep the host span ``name`` from ``start`` (``host_ns()``) to now,
    under the step index of ``dev``'s ring (-1 before its first step)."""
    end = host_ns()
    ring = _rings.get(_device_of(dev)) if dev is not None else None
    _host.append((name, ring.step if ring is not None else -1, start, end))


@contextlib.contextmanager
def host_block(name: str, dev=None):
    """Keep the block as the host span ``name`` while spans are on."""
    if not enabled:
        yield
        return
    t0 = host_ns()
    try:
        yield
    finally:
        host_span(name, t0, dev)


def _to_host(ring: _Ring):
    """Device ns -> host ns: the newest clock sample's offset (the report's
    own), corrected by the drift between the first sample and it where they
    lie ``DRIFT_AFTER_NS`` or more apart; identity on the CPU. A sample's
    offset is good to about half its bracket (~10 us), so a drift taken
    over seconds would be noise. Returns (convert, the clock's
    summary)."""
    if ring.dev.type == "cpu":
        return (lambda t: t), {"host_clock": HOST_CLOCK, "offset_ns": 0,
                               "offset_ns_at_enable": 0, "drift_ppm": 0.0,
                               "bracket_ns": 0}
    ring.clock[1:] = [_clock_sample(ring)]
    s0, s1 = ring.clock[0], ring.clock[-1]
    o0 = s0["host_ns"] - s0["device_ns"]
    o1 = s1["host_ns"] - s1["device_ns"]
    span = s1["device_ns"] - s0["device_ns"]
    drift = (o1 - o0) / span if span > 0 else 0.0
    slope = drift if span >= DRIFT_AFTER_NS else 0.0

    def convert(t):
        return t + o1 + round(slope * (t - s1["device_ns"]))

    return convert, {"host_clock": HOST_CLOCK, "offset_ns": o1,
                     "offset_ns_at_enable": o0, "drift_ppm": drift * 1e6,
                     "bracket_ns": s1["bracket_ns"]}


def _steps(records: list, convert) -> list:
    """The complete steps of the records: each a list of (name, host ns,
    counter) from its ``step.open`` to its ``step.optimizer``, with its
    index. A step whose open mark the ring has overwritten, or that never
    closed (a tet step taken again eagerly after its flag), is left out."""
    out, cur = [], None
    for sid, step, t, c in records:
        if sid < 0:
            continue
        name = MARKS[sid]
        if name == OPEN_STEP:
            cur = (step, [(name, convert(t), c)])
        elif cur is not None and step == cur[0]:
            cur[1].append((name, convert(t), c))
            if name == CLOSE_STEP:
                out.append(cur)
                cur = None
    return out


def _stat(values: list) -> dict:
    total = sum(values)
    return {"count": len(values), "total_ms": total,
            "mean_ms": total / len(values) if values else 0.0}


def _host_at(spans: list, starts: list, t: int) -> str:
    """The innermost host span open at host time ``t`` (the latest start
    at or before ``t`` among those still open), or "none"."""
    k = bisect.bisect_right(starts, t)
    for name, _step, a, b in reversed(spans[:k]):
        if a <= t < b:
            return name
    return "none"


def report(last_steps: int | None = None, step=None) -> dict:
    """The marks of the last ``last_steps`` complete steps (all kept ones
    with None) of the device where the last step opened, read from its
    ring once; {} while spans are off. Keys:

      steps, step_indices ([first, last]), device, window_ms (first open
      to last close) and step_ms (mean open to close);
      stages {name: {count, mean_ms, total_ms}} in step order;
      counters {name: {values (one a step), max}};
      gaps {"between_graphs", "between_steps": {count, mean_ms, total_ms,
      host {the host span open at the gap's start: count}}};
      per_step [{step, stages [[name, ms]], gaps [[kind, ms, host]],
      counters, marks [[name, host ns, counter]]}];
      host {name: {count, mean_ms, total_ms}} of the host spans in the
      steps' time, host_spans (those spans) and setup (the kept
      ``kernels.build``, ``step.eager`` and ``step.capture`` spans);
      clock (the host clock, the offset now and when turned on, the drift
      in ppm, the bracket of the newest sample);
      captures, replays, fallbacks: ``step``'s counters, where given."""
    if not enabled or not _rings:
        return {}
    dev = _last if _last in _rings else next(iter(_rings))
    ring = _rings[dev]
    records = ring.read()
    convert, clock = _to_host(ring)
    done = _steps(records, convert)
    if last_steps is not None:
        done = done[len(done) - min(int(last_steps), len(done)):]
    t0 = done[0][1][0][1] if done else 0
    t1 = done[-1][1][-1][1] if done else 0
    hosts = sorted((s for s in _host if s[3] > t0 and s[2] < t1),
                   key=lambda s: s[2])
    starts = [s[2] for s in hosts]
    stages, counters, per_step = {}, {}, []
    gaps = {"between_graphs": [], "between_steps": []}
    gap_host = {k: collections.Counter() for k in gaps}
    prev = None
    for idx, marks in done:
        row = {"step": idx, "stages": [], "gaps": [], "counters": {},
               "marks": [[n, t, c] for n, t, c in marks]}
        if prev is not None and prev[0] == idx - 1:
            g0 = prev[1][-1][1]
            ms = (marks[0][1] - g0) / 1e6
            h = _host_at(hosts, starts, g0)
            gaps["between_steps"].append(ms)
            gap_host["between_steps"][h] += 1
            row["gaps"].append(["between_steps", ms, h])
        for (_n, ta, _c), (name, tb, c) in zip(marks, marks[1:]):
            ms = (tb - ta) / 1e6
            if name == RESUME:
                h = _host_at(hosts, starts, ta)
                gaps["between_graphs"].append(ms)
                gap_host["between_graphs"][h] += 1
                row["gaps"].append(["between_graphs", ms, h])
                continue
            stages.setdefault(name, []).append(ms)
            row["stages"].append([name, ms])
            if name in COUNTERS:
                counters.setdefault(COUNTERS[name], []).append(c)
                row["counters"][COUNTERS[name]] = c
        per_step.append(row)
        prev = (idx, marks)
    host: dict = {}
    for name, _s, a, b in hosts:
        host.setdefault(name, []).append((b - a) / 1e6)
    counts = ({} if step is None else
              {k: int(getattr(step, k)) for k in
               ("captures", "replays", "fallbacks")})
    return {
        "steps": len(done),
        "step_indices": [done[0][0], done[-1][0]] if done else [],
        "device": str(dev),
        "window_ms": (t1 - t0) / 1e6,
        "step_ms": (sum(m[-1][1] - m[0][1] for _i, m in done) / 1e6
                    / len(done)) if done else 0.0,
        "stages": {k: _stat(v) for k, v in stages.items()},
        "counters": {k: {"values": v, "max": max(v)}
                     for k, v in counters.items()},
        "gaps": {k: {**_stat(v), "host": dict(gap_host[k])}
                 for k, v in gaps.items()},
        "per_step": per_step,
        "host": {k: _stat(v) for k, v in host.items()},
        "host_spans": hosts,
        "setup": [s for s in _host if s[0] in _SETUP],
        "clock": clock,
        **counts,
    }
