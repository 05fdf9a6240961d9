"""The tri frame and the tri train step as CUDA graphs, on the card.

The captured train step (``models.dmesh.TrainStep``) against eager steps
with the same capturable Adam, bit for bit over 5 steps, and the captured
loop; a ``TriRenderer`` frame captured by the caller's ``torch.cuda.graph``
against the eager frame; the overflow under capture kept as data; a batch
of new shapes capturing a graph of its own; a resume after captured steps;
the host syncs of an eager and a captured frame (``set_sync_debug_mode``);
and the refusals (a non-capturable optimiser), beside the bbox path
captured.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_graph.py
"""

import warnings

import pytest
import torch

from dmesh_renderer_tpu_torch import TriRenderSettings, TriRenderer
from dmesh_renderer_tpu_torch.models import dmesh
from dmesh_renderer_tpu_torch.ops import binning, geometry
from dmesh_renderer_tpu_torch.utils.checkpoint import (
    restore_checkpoint, save_checkpoint,
)
from dmesh_renderer_tpu_torch.utils.scenes import tri_scene

pytestmark = pytest.mark.gpu

H, W = 96, 80


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _user(dev, n=600, views=2, seed=3, h=H, w=W):
    """TriRenderer inputs on ``dev`` (row-major matrices)."""
    return [torch.from_numpy(x).to(dev) for x in tri_scene(n, views, h, w,
                                                           seed)]


def _problem(dev, views=2, h=H, w=W):
    """(fresh() -> TrainState with capturable Adam, faces, batch)."""
    v, f, vc, fo, mv, proj, vd, fi = _user(dev, views=views, h=h, w=w)
    mv_t = mv.transpose(1, 2).contiguous()
    proj_t = proj.transpose(1, 2).contiguous()
    inv = geometry.inverse44(torch.stack([mv_t, proj_t]))
    target = torch.rand((views, 3, h, w), generator=torch.Generator()
                        .manual_seed(5)).to(dev)
    batch = dmesh.ViewBatch(mv_t, proj_t, inv[0], inv[1], vd, fi, target)

    def fresh():
        scene = dmesh.TriScene(*(x.clone().requires_grad_(True)
                                 for x in (v, vc, fo)))
        return dmesh.init_train_state(scene, lambda p: torch.optim.Adam(
            p, lr=1e-2, capturable=True))

    return fresh, f, batch


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_captured_step_bitwise_equal_to_eager(cuda):
    """5 steps: the first eager, the second captured and replayed, three
    replays; every loss and parameter bitwise equal to 5 eager steps."""
    fresh, faces, batch = _problem(cuda)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    eager = dmesh.make_train_step(faces, bg, H, W, capture=False)
    graphed = dmesh.make_train_step(faces, bg, H, W)
    se, sg = fresh(), fresh()
    for i in range(5):
        se, le = eager(se, batch)
        sg, lg = graphed(sg, batch)
        assert torch.equal(le, lg), i
        assert _equal(se.scene, sg.scene), i
    assert (graphed.captures, graphed.replays) == (1, 4)
    assert (eager.captures, eager.replays) == (0, 0)
    # the returned loss is a copy: the next replay leaves it as it is
    kept = lg.clone()
    graphed(sg, batch)
    assert torch.equal(lg, kept)


def test_captured_loop_matches_steps(cuda):
    """``make_train_loop`` on the card replays one graph; its losses and
    parameters are those of eager steps."""
    fresh, faces, batch = _problem(cuda)
    bg = torch.zeros(3, device=cuda)
    loop = dmesh.make_train_loop(faces, bg, H, W, 6)
    sl, losses = loop(fresh(), batch)
    eager = dmesh.make_train_step(faces, bg, H, W, capture=False)
    se = fresh()
    want = torch.stack([eager(se, batch)[1] for _ in range(6)])
    assert torch.equal(losses, want)
    assert _equal(sl.scene, se.scene)
    assert (loop.step.captures, loop.step.replays) == (1, 5)


def test_new_batch_shape_captures_again(cuda):
    """A batch of other shapes captures a graph of its own; going back to
    the first shape replays the first graph."""
    fresh, faces, batch2 = _problem(cuda, views=2)
    batch1 = dmesh.ViewBatch(*(x[:1] for x in batch2))
    step = dmesh.make_train_step(faces, torch.zeros(3, device=cuda), H, W)
    st = fresh()
    for b in (batch2, batch2, batch1, batch1, batch2):
        st, loss = step(st, b)
        assert bool(torch.isfinite(loss))
    assert (step.captures, step.replays) == (2, 3)


def test_resume_after_captured_steps_is_bitwise(cuda, tmp_path):
    """2 steps, save, restore into a fresh state, 2 more steps: bitwise the
    4 uninterrupted steps (the restored optimiser's new state tensors are
    noticed: an eager step, then a new capture)."""
    fresh, faces, batch = _problem(cuda)
    step = dmesh.make_train_step(faces, torch.zeros(3, device=cuda), H, W)
    st, want = fresh(), []
    for _ in range(4):
        st, loss = step(st, batch)
        want.append(loss)
    part, got = fresh(), []
    for _ in range(2):
        part, loss = step(part, batch)
        got.append(loss)
    path = save_checkpoint(str(tmp_path / "c.pt"), part)
    resumed = restore_checkpoint(path, part)  # in place, same optimiser
    for _ in range(2):
        resumed, loss = step(resumed, batch)
        got.append(loss)
    assert _equal(got, want) and _equal(resumed.scene, st.scene)


def test_captured_serving_frame_bitwise(cuda):
    """After one warm-up call, a ``TriRenderer`` frame on device tensors
    is captured by the caller's ``torch.cuda.graph``; the replay is the
    eager frame bit for bit, aux included, and follows new inputs copied
    into the captured ones."""
    user = _user(cuda)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    r = TriRenderer(TriRenderSettings(H, W, bg), device="cuda")
    want = r(*user, return_aux=True)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = r(*user, return_aux=True)
    g.replay()
    torch.cuda.synchronize()
    assert _equal([*want[:2], *want[2]], [*got[:2], *got[2]])
    other = _user(cuda, seed=4)
    with torch.no_grad():
        for a, b in zip(user, other):
            a.copy_(b)
    g.replay()
    want2 = r(*other, return_aux=True)
    assert _equal([*want2[:2], *want2[2]], [*got[:2], *got[2]])
    assert int(want2[2][1]) != int(want[2][1])


def test_overflow_under_capture_is_data(cuda):
    """At a key capacity that drops pairs, the eager frame warns; under
    capture nothing is read or warned, and the replay gives the flag as
    data with outputs equal to the eager ones."""
    user = _user(cuda)
    bg = torch.zeros(3, device=cuda)
    r = TriRenderer(TriRenderSettings(H, W, bg, key_capacity=256), "cuda")
    with pytest.warns(UserWarning, match="key capacity"):
        want = r(*user, return_aux=True)
    assert bool(want[2][0])
    g = torch.cuda.CUDAGraph()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with torch.cuda.graph(g):
            got = r(*user, return_aux=True)
        g.replay()
    torch.cuda.synchronize()
    assert bool(got[2][0])
    assert _equal([*want[:2], *want[2]], [*got[:2], *got[2]])


def _syncs(fn):
    """Host syncs of ``fn()``: warnings of ``set_sync_debug_mode``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum(str(w.message).startswith("called a synchronizing")
               for w in rec)


def test_host_syncs(cuda):
    """An eager serving frame and an eager training frame read the host
    once each (the overflow flag); a captured step's replay none."""
    user = _user(cuda)
    bg = torch.zeros(3, device=cuda)
    r = TriRenderer(TriRenderSettings(H, W, bg), device="cuda")
    leaves = [user[i].clone().requires_grad_(True) for i in (0, 2, 3, 6, 7)]

    def train_frame():
        c, d = r(leaves[0], user[1], leaves[1], leaves[2], user[4], user[5],
                 leaves[3], leaves[4])
        (c.sum() + d.sum()).backward()

    train_frame()
    assert _syncs(lambda: r(*user)) <= 1
    assert _syncs(train_frame) <= 1
    fresh, faces, batch = _problem(cuda)
    step = dmesh.make_train_step(faces, bg, H, W)
    st = fresh()
    for _ in range(2):
        st, _loss = step(st, batch)
    assert _syncs(lambda: step(st, batch)) == 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(st, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_refusals(cuda):
    """On the card a step whose optimiser is not capturable raises (it
    does not quietly stay eager); the bbox emission path runs under capture
    and its replay equals the eager result."""
    fresh, faces, batch = _problem(cuda)
    step = dmesh.make_train_step(faces, torch.zeros(3, device=cuda), H, W)
    st = fresh()
    st = dmesh.init_train_state(st.scene, lambda p: torch.optim.Adam(p))
    with pytest.raises(RuntimeError, match="capturable"):
        step(st, batch)
    eager = dmesh.make_train_step(faces, torch.zeros(3, device=cuda), H, W,
                                  capture=False)
    _st, loss = eager(st, batch)  # capture=False: every step eager
    assert bool(torch.isfinite(loss))
    gen = torch.Generator().manual_seed(2)
    rmin = torch.randint(0, 3, (2, 40, 2), generator=gen, dtype=torch.int32)
    pre = {k: v.to(cuda) for k, v in (
        ("rect_min", rmin),
        ("rect_max", rmin + torch.randint(0, 3, (2, 40, 2), generator=gen,
                                          dtype=torch.int32)),
        ("min_depth", torch.rand((2, 40), generator=gen)))}
    pre["tiles"] = (pre["rect_max"] - pre["rect_min"]).prod(-1).int()
    want = binning.emit_and_sort(pre, 5, 5, 256, sort_by="min_depth")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = binning.emit_and_sort(pre, 5, 5, 256, sort_by="min_depth")
    g.replay()
    torch.cuda.synchronize()
    assert _equal(want, got) and int(got.total) > 0
