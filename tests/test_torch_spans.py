"""The train steps' program spans (``utils/spans.py``, switched and read
through ``utils.diagnostics``), on the CPU.

The eager tri step (the binned path) and the eager tet step (the binned
first hit) on small scenes of ``tests/scenes.py``: spans on or off, the
losses, parameters and Adam moments are bit for bit the same; each step's
report holds every stage once, in order, under one step index; the
counters are the frame's own pair and record totals; spans off leave no
ring and an empty report; the switch is part of the steps' fingerprint;
the ring wraps and ``last_steps`` picks the newest steps. The card's side
(the marks inside captured graphs, their kernels against a profiler trace)
is ``test_torch_gpu_spans.py``. This file imports no JAX:

    python -m pytest tests/test_torch_spans.py -q
"""

import numpy as np
import pytest
import torch

from dmesh_renderer_tpu_torch.convert import (
    tet_scene_from_numpy, tet_view_batch_from_numpy, tri_scene_from_numpy,
    view_batch_from_numpy,
)
from dmesh_renderer_tpu_torch.models import dmesh
from dmesh_renderer_tpu_torch.ops import geometry
from dmesh_renderer_tpu_torch.ops import tet as pt
from dmesh_renderer_tpu_torch.utils import connectivity, diagnostics, spans
import scenes

H, W, B = 32, 32, 2
LR = 1e-2


def tri_problem(dev, adam=torch.optim.Adam):
    """(state, step, batch) of a 20-triangle soup at 32x32, two views, on
    the binned path, with a fresh Adam (``adam``: its class)."""
    soup = scenes.random_triangle_soup(20, seed=31)
    mv, proj = scenes.ring_cameras(B, radius=3.0)
    vd, fi = scenes.soup_view_attrs(soup, B, seed=32)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    target = np.random.RandomState(33).uniform(
        0, 1, (B, 3, H, W)).astype(np.float32)
    batch = view_batch_from_numpy(mv_t, proj_t, np.linalg.inv(mv_t),
                                  np.linalg.inv(proj_t), vd, fi, target,
                                  device=dev)
    state = dmesh.init_train_state(
        tri_scene_from_numpy(soup["verts"], soup["verts_color"],
                             soup["faces_opacity"], device=dev),
        lambda p: adam(p, lr=LR, **_capturable(dev)))
    faces = torch.from_numpy(soup["faces"])
    bg = torch.tensor([0.1, 0.2, 0.3])
    step = dmesh.make_train_step(faces, bg, H, W, force="binned")
    return state, step, batch


def tet_problem(dev, adam=torch.optim.Adam):
    """(state, step, batch) of a jittered ``freudenthal_grid(3)`` at 32x32,
    two views, with a fresh Adam."""
    verts, tets = connectivity.freudenthal_grid(3, 0.15, 7)
    faces, face_tets, tet_faces = connectivity.build_tet_connectivity(tets)
    rng = np.random.RandomState(8)
    vc = rng.rand(verts.shape[0], 3).astype(np.float32)
    fo = rng.uniform(0.3, 0.9, faces.shape[0]).astype(np.float32)
    fi = rng.uniform(0.5, 1.0, (B, faces.shape[0])).astype(np.float32)
    mv, proj = scenes.ring_cameras(B)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    inv = geometry.inverse44(torch.from_numpy(np.stack([mv_t, proj_t])))
    target = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    batch = tet_view_batch_from_numpy(mv_t, proj_t, inv[0].numpy(),
                                      inv[1].numpy(), fi, target, device=dev)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    geom = dmesh.TetGeometry(torch.from_numpy(verts).to(dev), i32(faces),
                             i32(tets), i32(face_tets), i32(tet_faces))
    state = dmesh.init_tet_train_state(
        tet_scene_from_numpy(vc, fo, device=dev),
        lambda p: adam(p, lr=LR, **_capturable(dev)))
    step = dmesh.make_tet_train_step(geom, torch.tensor([0.1, 0.2, 0.3]), H,
                                     W)
    return state, step, batch


def _capturable(dev):
    return {"capturable": True} if torch.device(dev).type == "cuda" else {}


PROBLEMS = {"tri": (tri_problem, spans.TRI_STAGES),
            "tet": (tet_problem, spans.TET_STAGES)}


@pytest.fixture(autouse=True)
def spans_off(monkeypatch):
    """Spans off around each test; the tet step takes the binned first hit
    (K3's plain version) on these small scenes."""
    monkeypatch.setattr(pt, "BINNED_FIRST_HIT_THRESHOLD", 1)
    diagnostics.enable_spans(False)
    yield
    diagnostics.enable_spans(False)


def _trajectory(kind, n):
    """``n`` steps from a fresh state: each step's loss, parameters and
    Adam moments."""
    state, step, batch = PROBLEMS[kind][0]("cpu")
    out = []
    for _ in range(n):
        state, loss = step(state, batch)
        opt = state.opt_state
        out.append([loss.clone()] + [t.detach().clone() for p in state.scene
                                     for t in (p, opt.state[p]["exp_avg"],
                                               opt.state[p]["exp_avg_sq"])])
    return out


@pytest.mark.parametrize("kind", PROBLEMS)
def test_spans_leave_the_step_bit_identical(kind):
    off = _trajectory(kind, 3)
    diagnostics.enable_spans()
    on = _trajectory(kind, 3)
    assert spans.report()["steps"] == 3
    for a, b in zip(off, on):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kind", PROBLEMS)
def test_each_step_holds_every_stage_once_in_order(kind):
    diagnostics.enable_spans()
    state, step, batch = PROBLEMS[kind][0]("cpu")
    for _ in range(3):
        state, _loss = step(state, batch)
    rep = diagnostics.span_report(step=step)
    want = list(PROBLEMS[kind][1])
    assert rep["steps"] == 3 and rep["step_indices"] == [1, 3]
    assert [r["step"] for r in rep["per_step"]] == [1, 2, 3]
    for row in rep["per_step"]:
        assert [name for name, _ms in row["stages"]] == want
        assert all(ms >= 0 for _n, ms in row["stages"])
    assert list(rep["stages"]) == want
    assert all(s["count"] == 3 for s in rep["stages"].values())
    # eager steps on the CPU: no wait between graphs; one between steps
    # each, and each step is a host span of its own
    assert rep["gaps"]["between_graphs"]["count"] == 0
    assert rep["gaps"]["between_steps"]["count"] == 2
    assert rep["host"]["step.eager"]["count"] == 3
    assert (rep["captures"], rep["replays"], rep["fallbacks"]) == (0, 0, 0)
    assert "replays" not in diagnostics.span_report()
    assert rep["clock"]["offset_ns"] == 0
    # the stages and the gaps fill the window
    total = sum(s["total_ms"] for s in rep["stages"].values()) + rep["gaps"][
        "between_steps"]["total_ms"]
    assert total == pytest.approx(rep["window_ms"], rel=1e-9, abs=1e-6)


def test_tri_pairs_and_walked_are_the_frames_own():
    diagnostics.enable_spans()
    state, step, batch = tri_problem("cpu")
    start = [p.detach().clone() for p in state.scene]
    state, _loss = step(state, batch)
    rep = diagnostics.span_report()
    faces = step._host_consts[0]
    stats = diagnostics.tri_render_stats(start[0], faces, batch.mv_t,
                                         batch.proj_t, H, W)
    assert rep["counters"]["tri.pairs"]["values"] == [stats["num_rendered"]]
    walked = rep["counters"]["tri.walked"]["values"][0]
    assert 0 < walked <= stats["num_rendered"]


def test_tet_records_are_the_frames_record_count():
    diagnostics.enable_spans()
    state, step, batch = tet_problem("cpu")
    geom, bg = dmesh.TetGeometry(*step._host_consts[:5]), step._host_consts[5]
    color, _d, _a, saved = pt.render_tet_forward(
        geom.verts, geom.faces, *(p.detach() for p in state.scene),
        batch.mv_t, batch.proj_t, batch.inv_mv_t, batch.inv_proj_t,
        batch.faces_intense, geom.tets, geom.face_tets, geom.tet_faces, bg,
        H, W, 0)
    want = int(pt._record_counts(saved["is_active"], saved["last_face"],
                                 saved["n_contrib"]).sum())
    state, _loss = step(state, batch)
    rep = diagnostics.span_report()
    assert want > 0
    assert rep["counters"]["tet.records"]["values"] == [want]
    assert rep["counters"]["tet.fh_pairs"]["values"] == [
        int(saved["fh_num_rendered"])]


@pytest.mark.parametrize("kind", PROBLEMS)
def test_spans_off_leave_no_ring_and_an_empty_report(kind):
    state, step, batch = PROBLEMS[kind][0]("cpu")
    step(state, batch)
    assert spans._rings == {} and len(spans._host) == 0
    assert diagnostics.span_report() == {}
    assert spans.fingerprint() is None


def test_the_switch_is_part_of_the_fingerprint():
    state, _step, _batch = tri_problem("cpu")
    off = dmesh._fingerprint(state)
    diagnostics.enable_spans()
    on = dmesh._fingerprint(state)
    diagnostics.enable_spans(False)
    assert on != off and dmesh._fingerprint(state) == off
    diagnostics.enable_spans()
    assert dmesh._fingerprint(state) not in (on, off)


def test_the_ring_wraps_and_last_steps_picks_the_newest(monkeypatch):
    # 25 rows hold two whole tri steps (10 marks each) and half of one
    monkeypatch.setattr(spans, "RING_ROWS", 25)
    diagnostics.enable_spans()
    state, step, batch = tri_problem("cpu")
    for _ in range(5):
        state, _loss = step(state, batch)
    rep = diagnostics.span_report()
    assert [r["step"] for r in rep["per_step"]] == [4, 5]
    assert [r["step"] for r in diagnostics.span_report(1)["per_step"]] == [5]
    assert diagnostics.span_report(1)["host"]["step.eager"]["count"] == 1


def test_a_step_that_never_closed_is_left_out():
    """A tet step whose flag sent it to the eager fallback leaves its G1's
    marks without a close; the report takes the steps around it."""
    ids = spans._ID
    recs = []
    for step, close in ((1, True), (2, False), (3, True)):
        t = step * 100
        recs.append((ids["step.open"], step, t, 0))
        recs.append((ids["tet.first_hit"], step, t + 10, 7))
        recs.append((ids["step.grads"], step, t + 20, 0))
        if close:
            recs.append((ids["step.resume"], step, t + 30, 0))
            recs.append((ids["step.optimizer"], step, t + 40, 0))
    got = spans._steps(recs, lambda t: t)
    assert [s for s, _m in got] == [1, 3]
    assert [n for n, _t, _c in got[1][1]] == [
        "step.open", "tet.first_hit", "step.grads", "step.resume",
        "step.optimizer"]


def test_host_clock_is_the_profilers():
    assert diagnostics.profiler_clock() == spans.HOST_CLOCK


class _Event:
    def __init__(self, name, start, end, cuda=True):
        self.name = name
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.time_range = torch.autograd.profiler_util.Interval(start, end)


class _Trace:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_device_time_by_stage_follows_the_mark_kernels():
    """Each device event goes to the stage that the next mark kernel
    closes, in the trace's order; a host event is left out; a trace whose
    mark count differs from the report's raises."""
    mk = spans.MARK_KERNEL
    ev = [_Event("copy", 0, 1), _Event(mk, 2, 3), _Event("k3", 4, 6),
          _Event("gather", 7, 10), _Event(mk, 11, 12), _Event("k4", 13, 14),
          _Event(mk, 15, 16), _Event("opt", 17, 19), _Event(mk, 20, 21),
          _Event("host op", 5, 30, cuda=False), _Event("tail", 22, 23)]
    rep = {"per_step": [{"marks": [["step.open", 0, 0],
                                   ["tet.first_hit", 0, 0],
                                   ["step.resume", 0, 0],
                                   ["step.optimizer", 0, 0]]}]}
    got = diagnostics.device_time_by_stage(_Trace(ev), rep)
    assert got == {"between steps": {"copy": (1, 0.001)},
                   "tet.first_hit": {"gather": (1, 0.003),
                                     "k3": (1, 0.002)},
                   "between graphs": {"k4": (1, 0.001)},
                   "step.optimizer": {"opt": (1, 0.002)},
                   "after the last step": {"tail": (1, 0.001)}}
    with pytest.raises(ValueError, match="mark kernels"):
        diagnostics.device_time_by_stage(_Trace(ev[:2]), rep)
