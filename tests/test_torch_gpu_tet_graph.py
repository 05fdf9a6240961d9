"""The tet frame and the tet train step as CUDA graphs, on the card.

The captured tet train step (``models.dmesh.TetTrainStep``: G1 zero_grad,
forward and backward, one flag read, G2 the optimiser step) against eager
steps with the same capturable Adam, bit for bit, and the captured loop; a
``TetRenderer`` frame captured by the caller's ``torch.cuda.graph`` against
the eager frame; a batch of new shapes capturing again; a resume after
captured steps; a forced record overflow (``ops.tet.LOG_CAP`` 1) taken by
the exact fallback; and the host syncs of eager and captured frames and
steps (``set_sync_debug_mode``).

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_tet_graph.py
"""

import warnings

import numpy as np
import pytest
import torch

from dmesh_renderer_tpu_torch import TetRenderSettings, TetRenderer
from dmesh_renderer_tpu_torch.models import dmesh
from dmesh_renderer_tpu_torch.ops import geometry
from dmesh_renderer_tpu_torch.ops import tet as pt
from dmesh_renderer_tpu_torch.utils.checkpoint import (
    restore_checkpoint, save_checkpoint,
)
from dmesh_renderer_tpu_torch.utils.scenes import tet_scene

pytestmark = pytest.mark.gpu

H, W = 96, 80
GRID = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _user(dev, views=2, h=H, w=W, grid=GRID):
    """TetRenderer inputs on ``dev`` (row-major matrices) and bg."""
    arrs = tet_scene(grid, views, h, w)
    return ([torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in arrs[:11]], torch.from_numpy(arrs[11]).to(dev))


def _problem(dev, views=2, h=H, w=W, seed=0):
    """(fresh() -> TrainState with capturable Adam, make_step(**kw),
    make_loop(n), batch)."""
    user, bg = _user(dev, views, h, w)
    mv_t = user[4].transpose(1, 2).contiguous()
    proj_t = user[5].transpose(1, 2).contiguous()
    inv = geometry.inverse44(torch.stack([mv_t, proj_t]))
    target = torch.rand((views, 3, h, w), generator=torch.Generator()
                        .manual_seed(5)).to(dev)
    batch = dmesh.TetViewBatch(mv_t, proj_t, inv[0], inv[1], user[7], target)
    geom = dmesh.TetGeometry(user[0], user[1], *user[8:11])

    def fresh():
        scene = dmesh.TetScene(*(x.clone().requires_grad_(True)
                                 for x in (user[2], user[3])))
        return dmesh.init_tet_train_state(scene, lambda p: torch.optim.Adam(
            p, lr=1e-2, capturable=True))

    def make_step(**kw):
        return dmesh.make_tet_train_step(geom, bg, h, w, seed=seed, **kw)

    def make_loop(n):
        return dmesh.make_tet_train_loop(geom, bg, h, w, n, seed=seed)

    return fresh, make_step, make_loop, batch


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("seed", [0, 3])
def test_captured_step_bitwise_equal_to_eager(cuda, seed):
    """5 steps: the first eager, the second captured and replayed, three
    replays; every loss, gradient and parameter bitwise equal to 5 eager
    steps, with and without jittered rays."""
    fresh, make_step, _loop, batch = _problem(cuda, seed=seed)
    eager, graphed = make_step(capture=False), make_step()
    se, sg = fresh(), fresh()
    for i in range(5):
        se, le = eager(se, batch)
        sg, lg = graphed(sg, batch)
        assert torch.equal(le, lg), i
        assert _equal(se.scene, sg.scene), i
        assert _equal([p.grad for p in se.scene],
                      [p.grad for p in sg.scene]), i
    assert (graphed.captures, graphed.replays, graphed.fallbacks) == (1, 4, 0)
    assert (eager.captures, eager.replays) == (0, 0)
    kept = lg.clone()
    graphed(sg, batch)
    assert torch.equal(lg, kept)


def test_captured_loop_matches_steps(cuda):
    """``make_tet_train_loop`` on the card replays the step's graphs; its
    losses and parameters are those of eager steps."""
    fresh, make_step, make_loop, batch = _problem(cuda)
    loop = make_loop(6)
    sl, losses = loop(fresh(), batch)
    eager = make_step(capture=False)
    se = fresh()
    want = torch.stack([eager(se, batch)[1] for _ in range(6)])
    assert torch.equal(losses, want)
    assert _equal(sl.scene, se.scene)
    assert (loop.step.captures, loop.step.replays) == (1, 5)


def test_new_batch_shape_captures_again(cuda):
    """A batch of other shapes captures graphs of their own; going back to
    the first shape replays the first ones."""
    fresh, make_step, _loop, batch2 = _problem(cuda, views=2)
    batch1 = dmesh.TetViewBatch(*(x[:1] for x in batch2))
    step = make_step()
    st = fresh()
    for b in (batch2, batch2, batch1, batch1, batch2):
        st, loss = step(st, b)
        assert bool(torch.isfinite(loss))
    assert (step.captures, step.replays) == (2, 3)


def test_resume_after_captured_steps_is_bitwise(cuda, tmp_path):
    """2 steps, save, restore into the state in place, 2 more steps:
    bitwise the 4 uninterrupted steps (the restored optimiser's new state
    tensors are noticed: an eager step, then a new capture)."""
    fresh, make_step, _loop, batch = _problem(cuda)
    step = make_step()
    st, want = fresh(), []
    for _ in range(4):
        st, loss = step(st, batch)
        want.append(loss)
    part, got = fresh(), []
    for _ in range(2):
        part, loss = step(part, batch)
        got.append(loss)
    path = save_checkpoint(str(tmp_path / "c.pt"), part)
    resumed = restore_checkpoint(path, part)
    for _ in range(2):
        resumed, loss = step(resumed, batch)
        got.append(loss)
    assert _equal(got, want) and _equal(resumed.scene, st.scene)


def test_forced_record_overflow_under_capture(cuda, monkeypatch):
    """With the record capacity at one record a ray (``LOG_CAP`` 1), every
    captured step's G1 flags an overflow: the step is taken by the exact
    fallback, bitwise an eager step and bitwise the steps at the full
    capacity, and counted in ``fallbacks``."""
    fresh, make_step, _loop, batch = _problem(cuda)
    full = make_step(capture=False)
    sf, want = fresh(), []
    for _ in range(4):
        sf, loss = full(sf, batch)
        want.append((loss, [p.detach().clone() for p in sf.scene]))
    monkeypatch.setattr(pt, "LOG_CAP", 1)
    eager, graphed = make_step(capture=False), make_step()
    se, sg = fresh(), fresh()
    for i in range(4):
        se, le = eager(se, batch)
        sg, lg = graphed(sg, batch)
        assert torch.equal(le, lg) and torch.equal(lg, want[i][0]), i
        assert _equal(se.scene, sg.scene) and _equal(sg.scene, want[i][1]), i
    assert (graphed.captures, graphed.replays, graphed.fallbacks) == (1, 0, 3)


def test_captured_serving_frame_bitwise(cuda):
    """After one warm-up call, a ``TetRenderer`` frame on device tensors is
    captured by the caller's ``torch.cuda.graph``; the replay is the eager
    frame bit for bit, aux included, and follows new inputs copied into the
    captured ones."""
    user, bg = _user(cuda)
    r = TetRenderer(TetRenderSettings(H, W, bg), device="cuda")
    want = r(*user, return_aux=True)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = r(*user, return_aux=True)
    g.replay()
    torch.cuda.synchronize()
    assert _equal([*want[:3], *want[3]], [*got[:3], *got[3]])
    with torch.no_grad():
        user[2].copy_(user[2].flip(0))
        user[3].copy_(user[3].flip(0))
    g.replay()
    want2 = r(*user, return_aux=True)
    assert _equal([*want2[:3], *want2[3]], [*got[:3], *got[3]])
    assert not torch.equal(want2[0], want[0])


def test_overflow_under_capture_is_data(cuda):
    """At a key capacity that drops pairs, the eager frame warns; under
    capture nothing is read or warned, and the replay gives the flag as
    data with outputs equal to the eager ones."""
    user, bg = _user(cuda)
    r = TetRenderer(TetRenderSettings(H, W, bg, key_capacity=256), "cuda")
    with pytest.warns(UserWarning, match="key capacity"):
        want = r(*user, return_aux=True)
    assert bool(want[3][0])
    g = torch.cuda.CUDAGraph()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with torch.cuda.graph(g):
            got = r(*user, return_aux=True)
        g.replay()
    torch.cuda.synchronize()
    assert bool(got[3][0])
    assert _equal([*want[:3], *want[3]], [*got[:3], *got[3]])


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
    once each (the first hit's flag and pair count and the record total,
    in one transfer); a captured step exactly once (the flag between its
    two graphs)."""
    user, bg = _user(cuda)
    r = TetRenderer(TetRenderSettings(H, W, bg), device="cuda")
    leaves = [user[i].clone().requires_grad_(True) for i in (2, 3)]

    def train_frame():
        c, d, _a = r(user[0], user[1], leaves[0], leaves[1], *user[4:])
        (c.sum() + d.sum()).backward()

    train_frame()
    assert _syncs(lambda: r(*user)) <= 1
    assert _syncs(train_frame) <= 1
    fresh, make_step, _loop, batch = _problem(cuda)
    step = make_step()
    st = fresh()
    for _ in range(2):
        st, _loss = step(st, batch)
    assert _syncs(lambda: step(st, batch)) == 1
    assert (step.captures, step.replays) == (1, 2)
