"""The readers of the program's spans (``metrics/_spans.py`` and the five
metrics that load it), on the CPU: synthetic steps of a span report, tet
and tri, their five readings, the check that the stages and the waits add
up to the marked span (a step left out fails it), the warm-up's steps
apart from the traced ones, and the stderr line; on the CPU nothing is
read and the spans stay off. Run from the root of a checkout:

    python -m pytest portbench/tests/test_portbench_spans.py -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from harness import spec  # noqa: E402

METRICS = ("binning_ms", "tri_reduce_ms", "tet_reduce_ms", "flag_wait_ms",
           "replay_gap_ms")
TET = {"tet.first_hit": 1.0, "tet.tables": 0.5, "tet.k4": 0.25,
       "step.loss": 0.125, "tet.bwd_start": 3.0, "tet.k5": 0.3,
       "tet.reduce": 1.25, "step.grads": 0.05, "step.optimizer": 0.1}
TRI = {"tri.project": 0.1, "tri.binning": 1.5, "tri.prep": 0.4,
       "tri.k1": 0.1, "step.loss": 0.05, "tri.k2": 0.3, "tri.reduce": 0.25,
       "step.grads": 0.05, "step.optimizer": 0.1}


def _rows(stages: dict, graph: float | None, gaps: list, steps: list,
          t0: int = 10 ** 12) -> list:
    """``span_report``'s ``per_step`` of the steps with the indices
    ``steps``: each stage takes ``stages`` ms, the wait between the graphs
    ``graph`` ms (None: one graph), and ``gaps[k]`` ms pass before step k
    (step k's between-step wait where its index follows the one before)."""
    ns = lambda ms: round(ms * 1e6)
    rows, t, prev = [], t0, None
    for k, idx in enumerate(steps):
        t += ns(gaps[k])
        row = {"step": idx, "stages": [], "gaps": [],
               "counters": {"tet.records": 5}, "marks": [["step.open", t, 0]]}
        if prev == idx - 1:
            row["gaps"].append(["between_steps", gaps[k], "step.replay"])
        for name, ms in stages.items():
            if name == "step.optimizer" and graph is not None:
                t += ns(graph)
                row["marks"].append(["step.resume", t, 0])
                row["gaps"].append(["between_graphs", graph,
                                    "step.flag_read"])
            t += ns(ms)
            row["marks"].append([name, t, 0])
            row["stages"].append([name, ms])
        rows.append(row)
        prev = idx
    return rows


@pytest.fixture(scope="module")
def spans():
    return spec.metric_module("binning_ms")._s


def test_readings_of_tet_steps(spans):
    agg = spans.aggregate(_rows(TET, 0.04, [0.0, 0.08, 0.08, 0.08],
                                [10, 11, 12, 13]))
    assert spans.readings(agg) == {
        "binning_ms": None, "tri_reduce_ms": None,
        "tet_reduce_ms": pytest.approx(1.25),
        "flag_wait_ms": pytest.approx(0.04),
        "replay_gap_ms": pytest.approx(0.08)}
    assert agg["sum"] == pytest.approx(sum(TET.values()) + 0.04
                                       + 0.08 * 3 / 4)
    assert agg["sum"] == pytest.approx(agg["marked"], rel=1e-9)
    assert abs(spans.sum_check(agg)) < 1e-9
    assert agg["hosts"]["between_graphs"] == {"step.flag_read": 4}
    window = agg["sum"] * 1.01
    text = spans.line(agg, None, window, window - 0.5,
                      {"drift_ppm": 0.1, "bracket_ns": 9000})
    assert "(+0.00 %, held within 2 %)" in text and "(-0.99 %)" in text
    assert "tet.records max 5 last 5" in text
    assert f"inside the graphs {0.5 - 0.04 - 0.06:.4f}" in text
    assert "without the profiler" not in text


def test_readings_of_tri_steps(spans):
    agg = spans.aggregate(_rows(TRI, None, [0.0, 0.02, 0.04], [3, 4, 5]))
    got = spans.readings(agg)
    assert got["binning_ms"] == pytest.approx(1.5)
    assert got["tri_reduce_ms"] == pytest.approx(0.25)
    assert got["tet_reduce_ms"] is None and got["flag_wait_ms"] is None
    assert got["replay_gap_ms"] == pytest.approx(0.03)
    assert abs(spans.sum_check(agg)) < 1e-9


def test_a_step_left_out_of_the_marks_fails_the_sum_check(spans):
    """Step 12 never closed (a tet step taken again after its flag): the
    marked span holds its time and the wait around it, which no stage and
    no between-step wait holds."""
    agg = spans.aggregate(_rows(TET, 0.04, [0.0, 0.08, 6.0, 0.08],
                                [10, 11, 13, 14]))
    assert spans.sum_check(agg) < -spans.TOLERANCE
    assert agg["mean"]["between_steps"] == pytest.approx(0.08)


def test_the_warm_ups_steps_are_read_apart(spans):
    """The untraced steps are those closed by set-up's end, the newest
    consecutive ones; their waits are the step's without the profiler."""
    warm = _rows(TET, 0.02, [0.0] + [0.05] * 5, [1, 2, 4, 5, 6, 7])
    end = warm[-1]["marks"][-1][1]
    traced = _rows(TET, 0.04, [0.3] + [0.08] * 3, [9, 10, 11, 12],
                   t0=end + 10 ** 9)
    got = spans.untraced_rows(warm + traced, end)
    assert [r["step"] for r in got] == [4, 5, 6, 7]
    un, tr = spans.aggregate(got), spans.aggregate(traced)
    assert un["mean"]["between_graphs"] == pytest.approx(0.02)
    assert un["mean"]["between_steps"] == pytest.approx(0.05)
    text = spans.line(tr, un, tr["sum"], tr["sum"] - 0.2,
                      {"drift_ppm": 0.0, "bracket_ns": 1})
    assert "without the profiler, the warm-up's last 4 steps" in text
    assert f"(the untraced step) {un['sum']:.4f}" in text
    assert spans.untraced_rows(traced, end) == []


def test_records_check(spans):
    tet = spans.aggregate(_rows(TET, 0.04, [0.0] * 4, [1, 2, 3, 4]))
    tet["counters"]["tet.records"] = [5, 6, 5, 6]
    assert spans.records_check(tet, {"records": 22}, 2).endswith(
        "22 vs the reference's 22 (difference 0), repeating every 2 steps: "
        "True")
    assert "(difference 1)" in spans.records_check(tet, {"records": 21}, 2)
    assert spans.records_check(tet, {"records": 22}, 3).endswith("False")
    assert spans.records_check(tet, None, 2) == ""
    tri = spans.aggregate(_rows(TRI, None, [0.0, 0.1], [1, 2]))
    tri["counters"] = {"tri.pairs": [3, 3]}
    assert spans.records_check(tri, {"records": 1}, 2) == ""


class _Run:
    def __init__(self, dev):
        import torch

        self.dev = torch.device(dev)
        self.trace_units = 4
        self.trace_summary = {"window_s": 1.0, "busy_s": 0.9}


@pytest.mark.parametrize("metric", METRICS)
def test_the_readers_read_nothing_on_the_cpu(metric):
    """Each reader loads the helper and reads its own metric; on the CPU it
    returns None and leaves the program's spans off."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("the card is here")
    from dmesh_renderer_tpu_torch.utils import spans as program_spans

    mod = spec.metric_module(metric)
    assert metric in mod._s.READS
    run = _Run("cpu")
    assert mod.read(run) is None and run.spans_read is None
    assert not program_spans.enabled
