"""The tri binning's exact path on the card: the kernels of csrc/binning.cu
(``binning._exact_kernel``, the route ``emit_and_sort`` takes on CUDA
tensors) against the plain torch body (``binning.emit_exact_plain``) run on
the same card tensors, every ``BinnedKeys`` field bit for bit.

Scenes: the benchmark's ``tri_soup_100k_800`` (100,000 triangles at
800x800, drawn as ``portbench/harness/scenes.py`` draws it) at one view and
at 8 views, two seeds each; a key capacity that overflows; a run table
that ends inside one face's rows; a close camera whose faces have a vertex
near w=0 (the wrap-risk rule); an image of 250x250 pixels, whose last tile
row and column are partial; and views from which no face emits. Then the
bbox path (the tet first hit's ``sort_by="min_depth"``), which the kernels
do not touch; a captured call against the eager one with no host sync;
and the counter ``emit_and_sort.launches`` (once per eager call and at the
capture, never in a replay), also inside a captured tri train step.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_binning.py
"""

import sys
from pathlib import Path

import pytest
import torch

from dmesh_renderer_tpu_torch.models import dmesh
from dmesh_renderer_tpu_torch.ops import binning as tb
from dmesh_renderer_tpu_torch.ops import geometry

pytestmark = pytest.mark.gpu

PORTBENCH = Path(__file__).resolve().parents[1] / "portbench"
TILE = 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(dev, views, seed, faces=100_000, size=800, **cam):
    """The benchmark's tri scene and ``views`` ring views at ``seed`` on
    ``dev`` (``faces`` triangles at ``size`` x ``size``; ``cam`` overrides
    camera settings): (pre, grid_x, grid_y, B * F)."""
    sys.path.insert(0, str(PORTBENCH))
    from harness import spec
    from harness.scenes import make_scene, make_views

    cfg = spec.config(spec.load_benchmark(), "tri_soup_100k_800")
    cfg.update(faces=faces, height=size, width=size)
    cfg["cameras"] = dict(cfg["cameras"], **cam)
    scene, gen = make_scene(cfg, seed, dev)
    v = make_views(cfg, scene, gen, views, targets=False)
    pre, gx, gy = tb._scene_pre(scene.verts, scene.faces, v.mv_t, v.proj_t,
                                size, size, TILE)
    return pre, gx, gy, views * faces


def check(pre, gx, gy, kcap, run_cap=None):
    """The kernel route (one counted call) against the plain body on the
    same tensors, every field bit for bit. Returns the plain result."""
    want = tb.emit_exact_plain(pre, gx, gy, kcap, TILE, run_cap)
    before = tb.emit_and_sort.launches
    got = tb.emit_and_sort(pre, gx, gy, kcap, tile_px=TILE, run_cap=run_cap)
    assert tb.emit_and_sort.launches == before + 1
    for name, w, g in zip(want._fields, want, got):
        assert w.dtype == g.dtype and w.shape == g.shape, name
        assert torch.equal(w, g), name
    return want


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 4_000_000_007])
@pytest.mark.parametrize("views", [1, 8])
def test_benchmark_scene(cuda, views, seed):
    pre, gx, gy, n = _scene(cuda, views, seed)
    want = check(pre, gx, gy, tb.default_key_capacity(views, n // views))
    assert not bool(want.overflow)
    assert int(want.total) > 700_000 * views and int(want.runs) > 0


def test_key_overflow(cuda):
    """A key capacity that holds half the pairs: the farthest faces of the
    last view lose theirs."""
    pre, gx, gy, n = _scene(cuda, 8, 5, faces=20_000)
    full = check(pre, gx, gy, tb.default_key_capacity(8, 20_000))
    want = check(pre, gx, gy, int(full.total) // 2)
    assert bool(want.overflow) and int(want.total) == int(full.total)
    # the live slots, kcap of them, lie in the tiles' ranges
    assert int(want.ends[-1]) == int(full.total) // 2


def test_run_table_cut_inside_a_face(cuda):
    """A run table whose last row is a middle row of one face: the face
    keeps its rows below the capacity and loses the rest."""
    pre, gx, gy, n = _scene(cuda, 8, 6, faces=20_000)
    counts = tb.exact_tile_counts(pre, gx, gy, TILE)
    sigma = tb._depth_presort(pre, counts, "depth")
    ny = (pre["rect_max"][..., 1] - pre["rect_min"][..., 1]).reshape(-1)
    ny = torch.where(counts.reshape(-1) > 0, ny, 0)[sigma].long()
    incl = torch.cumsum(ny, 0)
    # a face with at least 3 rows, past the table's floor of 1024 rows,
    # whose rows hold a multiple of 128 strictly inside
    cap = incl - ny + 1
    cap = (cap + 127) // 128 * 128
    inside = (ny >= 3) & (cap < incl) & (cap >= 1024) & (cap < incl[-1] // 2)
    cap = int(cap[inside][0])
    assert tb.run_capacity(n, 1 << 22, cap) == cap
    full = check(pre, gx, gy, 1 << 22)
    want = check(pre, gx, gy, 1 << 22, run_cap=cap)
    assert bool(want.overflow) and int(want.runs) == int(full.runs)
    assert 0 < int(want.total) < int(full.total)


def test_wrap_risk_faces(cuda):
    """A camera 1.0 from the origin with its near plane at 0.01: faces
    with a vertex near w=0, whose edge functions can wrap, emit their
    whole rect."""
    pre, gx, gy, n = _scene(cuda, 2, 7, faces=3000, size=256, radius=1.0,
                            near=0.01)
    risk = tb._edge_wrap_risk(pre, gx, gy, TILE)
    counts = tb.exact_tile_counts(pre, gx, gy, TILE)
    assert bool((risk & (counts > 0)).any())
    check(pre, gx, gy, 1 << 17)


def test_partial_last_tiles(cuda):
    """250x250 pixels: 8x8 tiles, the last row and column partial; faces
    whose rects end on them."""
    pre, gx, gy, n = _scene(cuda, 3, 8, faces=3000, size=250)
    assert gx == gy == 8
    counts = tb.exact_tile_counts(pre, gx, gy, TILE)
    last = (pre["rect_max"][..., 0] == gx) & (pre["rect_max"][..., 1] == gy)
    assert bool((last & (counts > 0)).any())
    check(pre, gx, gy, 1 << 16)


def test_no_face_emits(cuda):
    """Cameras 30 from the origin with the far plane at 5: every face is
    culled, no pair is emitted, every slot holds the sentinel."""
    pre, gx, gy, n = _scene(cuda, 2, 9, faces=500, size=256, radius=30.0,
                            far=5.0)
    want = check(pre, gx, gy, 4096)
    assert int(want.total) == 0 and int(want.runs) == 0
    assert bool((want.slot_face == n).all())


def test_bbox_path_untouched(cuda):
    """``sort_by="min_depth"`` without ``tile_px`` (the tet first hit)
    takes the bbox path: ``_emit_bbox``'s result, no kernel launch."""
    pre, gx, gy, n = _scene(cuda, 2, 10, faces=3000, size=256)
    before = tb.emit_and_sort.launches
    got = tb.emit_and_sort(pre, gx, gy, 1 << 16, sort_by="min_depth")
    want = tb._emit_bbox(pre, gx, gy, 1 << 16, "min_depth")
    assert tb.emit_and_sort.launches == before
    assert int(got.total) > 0
    for name, w, g in zip(want._fields, want, got):
        assert torch.equal(w, g), name


def _no_sync(fn):
    """``fn()`` with any host sync an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_captured_replay(cuda):
    """A captured call replayed equals the eager call, bit for bit; the
    eager call and the replays read nothing on the host; the kernels are
    launched once per eager call, once at the capture, and not in a
    replay."""
    pre, gx, gy, n = _scene(cuda, 8, 11, faces=20_000)
    kcap = tb.default_key_capacity(8, 20_000)
    run = lambda: tb.emit_and_sort(pre, gx, gy, kcap, tile_px=TILE)
    run()  # the build, outside the sync check
    counts = []
    before = tb.emit_and_sort.launches
    want = _no_sync(run)
    counts.append(tb.emit_and_sort.launches - before)
    g = torch.cuda.CUDAGraph()
    before = tb.emit_and_sort.launches
    with torch.cuda.graph(g):
        got = run()
    counts.append(tb.emit_and_sort.launches - before)
    for _ in range(3):
        before = tb.emit_and_sort.launches
        _no_sync(g.replay)
        counts.append(tb.emit_and_sort.launches - before)
    torch.cuda.synchronize()
    assert counts == [1, 1, 0, 0, 0]
    for name, w, x in zip(want._fields, want, got):
        assert torch.equal(w, x), name


def test_captured_train_step_launches(cuda):
    """A captured tri train step: the binning's kernels once in the eager
    step, once at the capture, never in a replay."""
    from dmesh_renderer_tpu_torch.utils.scenes import tri_scene

    h, w = 96, 80
    v, f, vc, fo, mv, proj, vd, fi = [
        torch.from_numpy(x).to(cuda) for x in tri_scene(600, 2, h, w, 3)]
    mv_t = mv.transpose(1, 2).contiguous()
    proj_t = proj.transpose(1, 2).contiguous()
    inv = geometry.inverse44(torch.stack([mv_t, proj_t]))
    target = torch.rand((2, 3, h, w), generator=torch.Generator()
                        .manual_seed(5)).to(cuda)
    batch = dmesh.ViewBatch(mv_t, proj_t, inv[0], inv[1], vd, fi, target)
    scene = dmesh.TriScene(*(x.clone().requires_grad_(True)
                             for x in (v, vc, fo)))
    st = dmesh.init_train_state(scene, lambda p: torch.optim.Adam(
        p, lr=1e-2, capturable=True))
    step = dmesh.make_train_step(f, torch.zeros(3, device=cuda), h, w)
    counts = []
    for _ in range(5):
        before = tb.emit_and_sort.launches
        st, loss = step(st, batch)
        torch.cuda.synchronize()
        counts.append(tb.emit_and_sort.launches - before)
        assert bool(torch.isfinite(loss))
    assert (step.captures, step.replays) == (1, 4)
    # step 1 eager, step 2 captures (and replays), steps 3-5 replay
    assert counts == [1, 1, 0, 0, 0]
