"""The train steps' program spans inside captured CUDA graphs, on the card.

The captured tri step (one graph) and tet step (G1, the flag read, G2) of
``test_torch_spans.py``'s small scenes: outputs bit for bit the same with
spans on and off; each replay appends its step's marks; with spans off a
profiler trace of replays holds no mark kernel, so a replay runs the graphs
it ran before spans existed; with spans on, each mark's stamp lies on the
host clock within half a clock sample's bracket, keeps within 10 us of
its own kernel's start in a ``torch.profiler`` trace once the session's
common difference is taken out (the profiler's own conversion of GPU
times moves by session; the median, printed, stays under 120 us), the
stages and the waits fill the marked span, and the trace's kernels
fall into their stages (``device_time_by_stage``); no host sync is
added.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_spans.py -s
"""

import statistics

import pytest
import torch

from dmesh_renderer_tpu_torch.tools.tri_step_ms import host_syncs
from dmesh_renderer_tpu_torch.utils import diagnostics, spans
from test_torch_spans import tet_problem, tri_problem

pytestmark = pytest.mark.gpu

PROBLEMS = {"tri": (tri_problem, spans.TRI_STAGES, 10),
            "tet": (tet_problem, spans.TET_STAGES, 11)}
MARK_KERNEL = spans.MARK_KERNEL
# a kernel each problem's step launches, and the stage that holds it
KERNEL_STAGE = {"tri": ("tri_bwd_kernel", "tri.k2"),
                "tet": ("tet_bwd_march_kernel", "tet.k5")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    diagnostics.enable_spans(False)
    yield torch.device("cuda")
    diagnostics.enable_spans(False)


def _steps(kind, n, dev):
    """A fresh state's step object after ``n`` steps (eager, capture and
    replay, replays): (state, step, batch, per step [loss, parameters, Adam
    moments])."""
    state, step, batch = PROBLEMS[kind][0](dev)
    out = []
    for _ in range(n):
        state, loss = step(state, batch)
        opt = state.opt_state
        out.append([loss.clone()] + [t.detach().clone() for p in state.scene
                                     for t in (p, opt.state[p]["exp_avg"],
                                               opt.state[p]["exp_avg_sq"])])
    torch.cuda.synchronize()
    return state, step, batch, out


@pytest.mark.parametrize("kind", PROBLEMS)
def test_captured_steps_bit_identical_with_spans_on_and_off(cuda, kind):
    _s, step_off, _b, off = _steps(kind, 5, cuda)
    diagnostics.enable_spans()
    _s, step_on, _b, on = _steps(kind, 5, cuda)
    assert step_off.captures == step_on.captures == 1
    assert step_on.replays == 4
    for a, b in zip(off, on):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kind", PROBLEMS)
def test_each_replay_appends_its_marks(cuda, kind):
    diagnostics.enable_spans()
    state, step, batch, _out = _steps(kind, 2, cuda)
    ring = spans._rings[torch.device("cuda", torch.cuda.current_device())]
    head = int(ring.state[0])
    n = 6
    for _ in range(n):
        state, _loss = step(state, batch)
    torch.cuda.synchronize()
    per_step = PROBLEMS[kind][2]
    assert int(ring.state[0]) - head == per_step * n
    rep = diagnostics.span_report(n, step=step)
    want = list(PROBLEMS[kind][1])
    assert rep["steps"] == n and rep["replays"] == step.replays
    idx = [r["step"] for r in rep["per_step"]]
    assert idx == list(range(idx[0], idx[0] + n))
    for row in rep["per_step"]:
        assert [name for name, _ms in row["stages"]] == want
    graphs = rep["gaps"]["between_graphs"]
    assert graphs["count"] == (n if kind == "tet" else 0)
    assert rep["gaps"]["between_steps"]["count"] == n - 1
    assert rep["host"]["step.replay"]["count"] == n
    # the stages and the waits fill the marked span, first open to last
    # close, within 2 % (the benchmark's check of its traced steps)
    total = sum(s["total_ms"] for s in rep["stages"].values()) + sum(
        g["total_ms"] for g in rep["gaps"].values())
    assert total == pytest.approx(rep["window_ms"], rel=0.02)
    if kind == "tet":
        assert set(graphs["host"]) <= {"step.flag_read", "step.replay"}
        assert rep["counters"]["tet.records"]["max"] > 0
    else:
        assert rep["counters"]["tri.pairs"]["max"] > 0


def _traced(kind, n, dev, on):
    """A profiler trace of ``n`` replays after two warm steps, and the
    step's report of them (spans ``on``)."""
    from torch.profiler import ProfilerActivity, profile

    if on:
        diagnostics.enable_spans()
    state, step, batch, _out = _steps(kind, 2, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _loss = step(state, batch)
        torch.cuda.synchronize()
    rep = diagnostics.span_report(n) if on else {}
    return prof, rep


@pytest.mark.parametrize("kind", PROBLEMS)
def test_spans_off_put_no_mark_in_a_replay(cuda, kind):
    prof, _rep = _traced(kind, 3, cuda, on=False)
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert names and not any(MARK_KERNEL in n for n in names)


@pytest.mark.parametrize("kind", PROBLEMS)
def test_mark_stamps_agree_with_the_profilers_kernels(cuda, kind):
    assert diagnostics.profiler_clock() == spans.HOST_CLOCK
    n = 3
    prof, rep = _traced(kind, n, cuda, on=True)
    base = prof.profiler.kineto_results.trace_start_ns()
    kernels = sorted(base + e.time_range.start * 1000 for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and MARK_KERNEL in e.name)
    marks = [t for row in rep["per_step"] for _n, t, _c in row["marks"]]
    assert len(marks) == len(kernels) == PROBLEMS[kind][2] * n
    diffs = [(m - k) / 1e3 for m, k in zip(marks, kernels)]
    common = statistics.median(diffs)
    off = [abs(d - common) for d in diffs]
    print(f"\n{kind}: mark stamp - its kernel's start in the trace: median "
          f"{common:.2f} us, each mark within {max(off):.2f} us of it, over "
          f"{len(diffs)} marks; clock {rep['clock']}")
    # each mark against its own kernel: the stamps keep the trace's order
    # and spacing to a few us
    assert max(off) < 10.0
    # the two conversions to the host clock: the stamps' is good to half
    # a clock sample's bracket (test_stamps_lie_on_the_host_clock); the
    # profiler's conversion of GPU times moves by session: medians of
    # -0.8 to 8.7 us, and once 97.5 us, over six sessions on an H100
    assert abs(common) < 120.0
    # the trace's kernels by stage: the backward kernel in its own stage,
    # once a step
    kernel, stage = KERNEL_STAGE[kind]
    by_stage = diagnostics.device_time_by_stage(prof, rep)
    hits = {st: c for st, d in by_stage.items() for name, (c, _ms) in
            d.items() if kernel in name}
    assert hits == {stage: n}


def test_stamps_lie_on_the_host_clock(cuda):
    """A mark launched right after a synchronize, its stamp put on the host
    clock by a report's conversion (``spans._to_host``), lies between the
    host reads around it, give or take half the bracket of the clock sample
    the conversion took."""
    diagnostics.enable_spans()
    ring = spans._rings[torch.device("cuda", torch.cuda.current_device())]
    convert, _clock = spans._to_host(ring)
    slack = ring.clock[-1]["bracket_ns"] // 2
    for _ in range(5):
        torch.cuda.synchronize()
        a = spans.host_ns()
        spans._launch(ring, ring.clock_row, ring.clock_state,
                      ring.clock_state, 1, -1, False, 0)
        torch.cuda.synchronize()
        b = spans.host_ns()
        t = convert(int(ring.clock_row[0, 2]))
        assert a - slack <= t <= b + slack, (a, t, b, slack)


@pytest.mark.parametrize("kind", PROBLEMS)
def test_spans_add_no_host_sync_to_a_replay(cuda, kind):
    diagnostics.enable_spans()
    state, step, batch, _out = _steps(kind, 2, cuda)
    syncs = host_syncs(lambda: [step(state, batch) for _ in range(4)])
    assert syncs == (4 if kind == "tet" else 0)
