"""The tri binning's (face, tile-row) run table at 8 views a step, on the
CPU (``ops/binning.py``).

- ``run_capacity`` past the JAX package's 2^21-row ceiling, from the
  heuristic and from an explicit ``run_cap``, and unchanged where the JAX
  package's is below it: 400,000 rows for the headline scene at one view.
- A run table too small for 8 views of a small scene sets ``overflow``,
  and the warning names the table that overflowed and the setting to
  raise; both wordings (key slots, run table), their sum, and a render
  with no run table; the captured step's ``steps`` (stood in for on the
  CPU) words its one warning from the run count it keeps.
- An eager step of 8 views (loss on colour and depth, so that all five
  gradients are live, and one Adam update) against the benchmark's plain
  reference (``portbench/reference/tri.py``, one view at a time), on
  seeded random inputs drawn by the benchmark's own generator.
- The counter ``tri.runs`` of an eager train step (``utils/spans.py``)
  against the runs counted on the host from the exact tile counts (held
  to the JAX package's by ``test_torch_binning.py``), with the run
  table's rows beside it.
"""

import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from dmesh_renderer_tpu.ops import binning as jb
from dmesh_renderer_tpu_torch.api import _inverses
from dmesh_renderer_tpu_torch.models import dmesh
from dmesh_renderer_tpu_torch.ops import binning as tb
from dmesh_renderer_tpu_torch.ops import geometry as tg
from dmesh_renderer_tpu_torch.ops.tri_binned import render_tri_binned
from dmesh_renderer_tpu_torch.utils import diagnostics

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "portbench"))
from harness import refside, spec  # noqa: E402
from harness.scenes import make_scene, make_views  # noqa: E402
from reference import tri as ref_tri  # noqa: E402

B = 8
JAX_CEILING = (1 << 21) - 128
SEED = 2 ** 31 + 9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these small frames run long loops of small torch
    ops, which gain nothing from more and, beside the suite's parallel
    workers, only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(faces, size, seed=SEED):
    """The benchmark's 8-view configuration's scene and views, cut to
    ``faces`` triangles at ``size`` x ``size``."""
    cfg = spec.config(spec.load_benchmark(), "tri_mv8_100k_800")
    cfg.update(faces=faces, height=size, width=size)
    scene, gen = make_scene(cfg, seed, "cpu")
    return cfg, scene, make_views(cfg, scene, gen, B, targets=True)


def _render(scene, views, size, leaves=None, **kw):
    verts, vcolor, fopac, vdepth, finten = leaves or (
        scene.verts, scene.vcolor, scene.fopac, views.vdepth, views.finten)
    inv_mv, inv_proj = _inverses(views.mv_t, views.proj_t)
    return render_tri_binned(verts, scene.faces, vcolor, fopac, views.mv_t,
                             views.proj_t, inv_mv, inv_proj, vdepth, finten,
                             scene.bg, size, size, **kw)


@pytest.mark.parametrize("views, faces, kcap, run_cap, rows", [
    (1, 100_000, None, None, 400_000),        # the headline at one view
    (8, 100_000, None, None, 3_200_000),      # its 8 views: past 2^21
    (8, 100_000, None, 3_000_000, 3_000_064),  # an explicit run_cap too
    (1, 100_000, None, 2_500_000, 2_500_096),
    (1, 48, 8192, None, 2048),
    (2, 10, None, 5, 1024),                   # the floor
])
def test_run_capacity(views, faces, kcap, run_cap, rows):
    if kcap is None:
        kcap = tb.default_key_capacity(views, faces)
    got = tb.run_capacity(views * faces, kcap, run_cap)
    assert got == rows
    jax_rows = jb._run_capacity(views * faces, kcap, run_cap)
    assert got == jax_rows if rows <= JAX_CEILING else jax_rows == JAX_CEILING


def test_overflow_warning_names_the_table():
    with pytest.warns(UserWarning) as rec:
        tb.overflow_warning(70, 64, "ctx", runs=10, run_cap=1024,
                            settings="TriRenderSettings")
        tb.overflow_warning(60, 64, "ctx", runs=2000, run_cap=1024,
                            settings="TriRenderSettings")
        tb.overflow_warning(70, 64, "ctx", runs=2000, run_cap=1024,
                            settings="TriRenderSettings")
        tb.overflow_warning(70, 64, "ctx", settings="TetRenderSettings")
    key, run, both, no_runs = (str(r.message) for r in rec)
    key_words = ("tile-binning key capacity overflow (70 (face, tile) pairs "
                 "emitted > capacity 64)")
    run_words = ("tile-binning run table overflow (2000 (face, tile-row) "
                 "runs emitted > capacity 1024 rows)")
    assert key.startswith("dmesh_renderer_tpu_torch (ctx; raise "
                          "TriRenderSettings.key_capacity): " + key_words)
    assert "Raise the key capacity." in key and "run" not in key
    assert run.startswith("dmesh_renderer_tpu_torch (ctx; raise "
                          "TriRenderSettings.run_capacity): " + run_words)
    assert "Raise the run capacity." in run and "key" not in run
    assert both.startswith("dmesh_renderer_tpu_torch (ctx; raise "
                           "TriRenderSettings.key_capacity and "
                           "TriRenderSettings.run_capacity): " + key_words)
    assert run_words in both
    # no run table (the tet first hit): the key slots alone
    assert no_runs.startswith("dmesh_renderer_tpu_torch (ctx; raise "
                              "TetRenderSettings.key_capacity): " + key_words)
    assert "run" not in no_runs.split("): ", 1)[1]


@pytest.mark.parametrize("auxes, words", [
    ([(False, 50, 100), (True, 60, 5000), (True, 2000, 6000)],
     "TriRenderSettings.run_capacity): tile-binning run table overflow "
     "(5000 (face, tile-row) runs emitted > capacity 1024 rows)"),
    ([(False, 50, 100), (True, 2000, 900)],
     "TriRenderSettings.key_capacity): tile-binning key capacity overflow "
     "(2000 (face, tile) pairs emitted > capacity 1280)"),
    ([(False, 50, 100), (False, 60, 200)], None),
])
def test_steps_words_the_first_overflow(monkeypatch, auxes, words):
    """``steps`` on its captured path, with ``_run`` stood in for: each
    step's flag, pairs and runs are kept on the device and read once at
    the end; the one warning gives the first overflowing step's counts
    against the tri step's capacities at 8 views of 10 faces (1,280 key
    slots, 1,024 run rows)."""
    step = dmesh.make_train_step(torch.zeros((10, 3), dtype=torch.int32),
                                 torch.zeros(3), 64, 64)
    given = iter(auxes)

    def run(state, batch, warn):
        assert not warn
        aux = tuple(torch.tensor(x) for x in next(given))
        return torch.tensor(1.0), aux, True

    monkeypatch.setattr(step, "_captured", lambda state, batch: True)
    monkeypatch.setattr(step, "_run", run)
    state = SimpleNamespace(scene=[torch.zeros(1)])
    batch = SimpleNamespace(mv_t=torch.zeros(B, 4, 4))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        losses = step.steps(state, batch, len(auxes))
    assert losses.tolist() == [1.0] * len(auxes)
    got = [str(r.message) for r in rec]
    if words is None:
        assert got == []
    else:
        (msg,) = got
        assert msg.startswith("dmesh_renderer_tpu_torch (render_tri_binned; "
                              "raise " + words)


@pytest.fixture(scope="module")
def small200():
    return _small(200, 64)


def test_small_run_table_overflows_and_warns(small200):
    _cfg, scene, views = small200
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("error")
        _c, _d, (ovf, total) = _render(scene, views, 64, with_aux=True)
    assert not bool(ovf)
    with torch.no_grad(), pytest.warns(UserWarning) as rec:
        _c, _d, (ovf, total2) = _render(scene, views, 64, with_aux=True,
                                        run_cap=1)
    # the runs past the table are dropped with their pairs
    assert bool(ovf) and int(total2) < int(total)
    (msg,) = [str(r.message) for r in rec]
    assert ("render_tri_binned; raise TriRenderSettings.run_capacity)"
            in msg)
    assert "tile-binning run table overflow (" in msg
    assert "runs emitted > capacity 1024 rows)" in msg
    assert "Raise the run capacity." in msg and "key capacity" not in msg
    runs = int(msg.split("run table overflow (")[1].split(" ")[0])
    assert runs > 1024


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_eager_b8_step_matches_the_reference():
    """Loss, the five gradients and one Adam update of 8 views in one call
    against the reference one view at a time, summed: float32 sums in
    another order, so within a few ulps of the norms (measured gaps
    ~1e-6 for the vertices, ~1e-7 for the rest)."""
    cfg, scene, views = _small(48, 64)
    H = cfg["height"]
    leaves = [x.detach().clone().requires_grad_(True) for x in
              (scene.verts, scene.vcolor, scene.fopac, views.vdepth,
               views.finten)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        color, depth = _render(scene, views, H, leaves)
    loss = ((color - views.target) ** 2).mean() + (depth ** 2).mean()
    loss.backward()
    opt = cfg["optimizer"]
    adam = torch.optim.Adam(leaves, lr=opt["lr"], betas=tuple(opt["betas"]),
                            eps=opt["eps"])
    start = [x.detach().clone() for x in leaves]
    adam.step()

    ref = [x.detach().clone().requires_grad_(True) for x in start]
    ref_loss = 0.0
    for b in range(B):
        i = [b]
        c, d, _a = ref_tri.render(ref[0], scene.faces, ref[1], ref[2],
                                  views.mv_t[i], views.proj_t[i], ref[3][i],
                                  ref[4][i], scene.bg, H, H)
        s = (((c - views.target[i]) ** 2).sum() / color.numel()
             + (d ** 2).sum() / depth.numel())
        s.backward()
        ref_loss += float(s.detach())
    assert loss.item() == pytest.approx(ref_loss, rel=1e-6)
    for p, r in zip(leaves, ref):
        assert float(r.grad.norm()) > 0
        assert _rel(p.grad, r.grad) < 1e-5
    for p, r, p0 in zip(leaves, ref, start):
        want = refside.adam_update(opt, p0, torch.zeros_like(p0),
                                   torch.zeros_like(p0), r.grad, 1)[0]
        assert _rel(p.detach() - p0, want - p0) < 1e-4


def _host_runs(scene, views, size):
    """The (face, tile-row) runs of the views, counted on the host: each
    (view, face) that covers a tile adds its rect's tile rows."""
    tile = 32
    grid = (size + tile - 1) // tile
    ndc, img = tg.project_verts(scene.verts, views.mv_t, views.proj_t, size,
                                size)
    pre = tg.preprocess_faces(ndc, img, scene.faces, size, size, tile, tile)
    cnt = tb.exact_tile_counts(pre, grid, grid, tile).numpy()
    rows = (pre["rect_max"][..., 1] - pre["rect_min"][..., 1]).numpy()
    return sum(int(r) for c, r in zip(cnt.ravel(), rows.ravel()) if c > 0)


def test_runs_counter_is_the_host_count():
    cfg, scene, views = _small(48, 64)
    size = cfg["height"]
    faces = scene.faces
    step = dmesh.make_train_step(faces, scene.bg, size, size, force="binned")
    state = dmesh.init_train_state(
        dmesh.TriScene(*(x.detach().clone().requires_grad_(True)
                         for x in (scene.verts, scene.vcolor, scene.fopac))),
        lambda p: torch.optim.Adam(p, lr=1e-2))
    inv_mv, inv_proj = _inverses(views.mv_t, views.proj_t)
    batch = dmesh.ViewBatch(views.mv_t, views.proj_t, inv_mv, inv_proj,
                            views.vdepth, views.finten, views.target)
    diagnostics.enable_spans()
    try:
        step(state, batch)
        rep = diagnostics.span_report()
    finally:
        diagnostics.enable_spans(False)
    want = _host_runs(scene, views, size)
    assert want > B * faces.shape[0] // 2
    assert rep["counters"]["tri.runs"]["values"] == [want]
    cap = tb.run_capacity(B * faces.shape[0],
                          tb.default_key_capacity(B, faces.shape[0]))
    assert rep["counters"]["tri.runs.capacity"]["values"] == [cap]
