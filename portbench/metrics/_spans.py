"""The port's program spans over a traced window: the shared helper of the
per-layer metrics that read a stage or a wait of the card (``binning_ms``,
``tri_reduce_ms``, ``tet_reduce_ms``, ``flag_wait_ms``,
``replay_gap_ms``). Loaded by path, as ``_roofline.py`` is; each reader
loads its own copy, and the copies share the run's one report, kept on the
run (``report``).

Turning spans on. The harness loads the readers only in a traced run, in
``runctx.Run.__init__``, before the driver builds the program. So this
module turns the program's spans on as it is loaded
(``utils.diagnostics.enable_spans()``): the step object that the driver
builds then captures its graphs with the stage marks in them, and every
step of the run, the warm-up's and the traced window's, stamps its stages
on the card's clock. Untraced runs, which give ``train_step_ms`` and
``setup_s``, never load it, so their graphs hold no marks. Where no card
is present, or where the program has no spans, it turns nothing on and the
readers return None: a number on the host's clock is never reported under
a device metric's name.

Reading. ``report(run)`` reads ``span_report()`` once a run, after the
traced window (then the driver frees the program, and only the plain
reference runs). The metrics come from its last ``run.trace_units``
steps: the traced window's, the same steps that the idle share and the
rooflines come from. They run under ``torch.profiler``, whose host work
lengthens the waits in which the card waits for the host: ``flag_wait_ms``
and ``replay_gap_ms`` are read under the profiler. So the stderr line
gives beside them the same stages and waits over the warm-up's last steps
(the steps that ended before set-up's ``warm-up`` mark, spans on and no
profiler, a sync every ``sync_every`` steps as in the untimed window):
their stages and waits a step add up to the untraced step on the card's
clock. The line also holds the counters, the check that the traced
steps' stages and waits add up to their marked span (first open to last
close; ``sum_check``, within ``TOLERANCE``, held by the tests), the same
sum against the profiler's window (information: the window also holds
the first launch and the last synchronize), and the tet step's record
count against the plain reference's (``records_check``).
"""

from __future__ import annotations

import collections
import math
import sys
import time

# metric -> (kind, what it reads): a stage's mean device ms a step, or a
# wait's mean device ms
READS = {"binning_ms": ("stage", "tri.binning"),
         "tri_reduce_ms": ("stage", "tri.reduce"),
         "tet_reduce_ms": ("stage", "tet.reduce"),
         "flag_wait_ms": ("gap", "between_graphs"),
         "replay_gap_ms": ("gap", "between_steps")}
TOLERANCE = 0.02  # the stages and the waits against the marked span
WAITS = ("between_graphs", "between_steps")


def _diagnostics():
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        from dmesh_renderer_tpu_torch.utils import diagnostics
    except ImportError:
        return None
    return diagnostics


def _enable() -> None:
    d = _diagnostics()
    if d is not None and hasattr(d, "enable_spans"):
        d.enable_spans()


def aggregate(rows: list) -> dict | None:
    """ms a step over consecutive steps of a report's ``per_step``: each
    stage; each wait's mean and its total over the steps a step (the wait
    between steps counted from the second step on: the first one's lies
    outside the steps) with the host spans open as the waits began; the
    stages and waits' sum; and the marked span a step (first open to last
    close). None without steps."""
    n = len(rows)
    if not n:
        return None
    stages: dict = {}
    waits = {k: [] for k in WAITS}
    hosts = {k: collections.Counter() for k in WAITS}
    counters: dict = {}
    for k, row in enumerate(rows):
        for name, ms in row["stages"]:
            stages[name] = stages.get(name, 0.0) + ms / n
        for kind, ms, host in row["gaps"]:
            if kind == "between_graphs" or k:
                waits[kind].append(ms)
                hosts[kind][host] += 1
        for name, value in row["counters"].items():
            counters.setdefault(name, []).append(value)
    per_step = {k: sum(v) / n for k, v in waits.items()}
    marked = (rows[-1]["marks"][-1][1] - rows[0]["marks"][0][1]) / 1e6 / n
    return {"steps": n, "stages": stages,
            "mean": {k: sum(v) / len(v) if v else None
                     for k, v in waits.items()},
            "per_step": per_step, "hosts": {k: dict(v) for k, v in
                                            hosts.items()},
            "counters": counters,
            "sum": sum(stages.values()) + sum(per_step.values()),
            "marked": marked}


def sum_check(agg: dict) -> float:
    """The stages and the waits a step against the marked span a step,
    relative: 0 where every step's marks are whole and the steps follow
    one another; a step left out of the marks (one that never closed)
    shows as a shortfall."""
    return agg["sum"] / agg["marked"] - 1.0


def readings(agg: dict) -> dict:
    """Each metric of ``READS`` from ``aggregate`` of the traced steps,
    None where they have no such stage or wait."""
    return {metric: agg["stages"].get(key) if kind == "stage"
            else agg["mean"][key] for metric, (kind, key) in READS.items()}


def _consecutive_tail(rows: list) -> list:
    """The last rows whose step indices follow one another."""
    k = len(rows)
    while k > 1 and rows[k - 2]["step"] == rows[k - 1]["step"] - 1:
        k -= 1
    return rows[k - 1:] if rows else []


def untraced_rows(rows: list, end_ns: int) -> list:
    """The steps that closed by host time ``end_ns`` (set-up's end: the
    warm-up's steps), the newest consecutive ones."""
    return _consecutive_tail([r for r in rows
                              if r["marks"][-1][1] <= end_ns])


def _stages(agg: dict) -> str:
    return " ".join(f"{k}={v:.4f}" for k, v in agg["stages"].items())


def _waits(agg: dict) -> str:
    return " ".join(f"{k}={agg['mean'][k]:.4f} (host {agg['hosts'][k]})"
                    for k in WAITS if agg["mean"][k] is not None)


def line(traced: dict, untraced: dict | None, window_ms: float,
         busy_ms: float, clock: dict) -> str:
    """The stderr line of a cell (module docstring): ``window_ms`` and
    ``busy_ms`` are the traced window's wall and device-busy time a step
    (the profiler's)."""
    counters = " ".join(f"{k} max {max(v)} last {v[-1]}"
                        for k, v in traced["counters"].items())
    idle = window_ms - busy_ms
    inside = idle - sum(traced["per_step"].values())
    out = (f"portbench: spans over {traced['steps']} traced steps (ms a "
           f"step): {_stages(traced)}; waits {_waits(traced)}; counters "
           f"{counters}; stages + waits {traced['sum']:.4f} vs the marked "
           f"span {traced['marked']:.4f} ({100.0 * sum_check(traced):+.2f} "
           f"%, held within {100.0 * TOLERANCE:g} %) vs the profiler's "
           f"window {window_ms:.4f} "
           f"({100.0 * (traced['sum'] / window_ms - 1.0):+.2f} %); idle "
           f"{idle:.4f}, of which inside the graphs {inside:.4f}")
    if untraced is not None:
        out += (f"; without the profiler, the warm-up's last "
                f"{untraced['steps']} steps: stages + waits (the untraced "
                f"step) {untraced['sum']:.4f}, waits {_waits(untraced)}, "
                f"stages {_stages(untraced)}")
    return (out + f"; clock drift {clock['drift_ppm']:.3f} ppm, bracket "
            f"{clock['bracket_ns']} ns")


def records_check(traced: dict, counts: dict | None, period: int) -> str:
    """The program's ``tet.records`` over the traced steps against the
    plain reference's ``records`` over the same steps (``run.counts``, what
    ``_roofline.k5`` reads), and whether the per-step values repeat with
    the traffic's period (the same views from the same parameters); "" for
    steps without the counter."""
    v = traced["counters"].get("tet.records")
    if v is None or not counts or "records" not in counts:
        return ""
    periodic = all(x == v[k % period] for k, x in enumerate(v))
    return (f"; tet.records over the steps {sum(v)} vs the reference's "
            f"{counts['records']} (difference {sum(v) - counts['records']}),"
            f" repeating every {period} steps: {periodic}")


def _warm_up_end_ns(run) -> int | None:
    """Set-up's ``warm-up`` mark (``time.perf_counter``) on the host clock
    of the report (``time.time_ns``)."""
    t = dict(run.marks).get("warm-up")
    if t is None:
        return None
    return time.time_ns() - round((time.perf_counter() - t) * 1e9)


def report(run) -> dict | None:
    """{"traced", "untraced"}: ``aggregate`` of the traced window's steps
    and of the warm-up's last ones, read once a run and kept on the run;
    None on the CPU, without spans or without a traced step."""
    if hasattr(run, "spans_read"):
        return run.spans_read
    out = None
    d = _diagnostics()
    if (d is not None and hasattr(d, "span_report")
            and run.dev.type == "cuda" and run.trace_units):
        end = _warm_up_end_ns(run)
        rep = d.span_report()
        rows = rep.get("per_step", [])
        traced = aggregate(rows[-run.trace_units:])
        if traced is not None:
            before = rows[:-run.trace_units]
            out = {"traced": traced, "untraced": aggregate(
                untraced_rows(before, end)) if end is not None else None}
            s = run.trace_summary
            if s is not None:
                n = run.trace_units
                tr = run.traffic
                period = math.lcm(int(tr["reset_every"]),
                                  int(tr["view_pool"])
                                  // int(tr["views_per_step"]))
                print(line(traced, out["untraced"], s["window_s"] * 1e3 / n,
                           s["busy_s"] * 1e3 / n, rep["clock"])
                      + records_check(traced, run.counts, period),
                      file=sys.stderr, flush=True)
    run.spans_read = out
    return out


def reading(run, metric: str) -> float | None:
    rep = report(run)
    return None if rep is None else readings(rep["traced"])[metric]


_enable()
