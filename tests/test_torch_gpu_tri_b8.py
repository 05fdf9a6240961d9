"""The tri train step at 8 views a step, on the card, at the scene of the
benchmark's cell ``tri100k_train_b8`` (``portbench/``: 100,000 triangles
at 800x800, the 8 ring views in one call): the captured step
(``models.dmesh.make_train_step``, as the cell builds it) over 3 steps --
the eager step, the capture and a replay -- against the plain reference
(``portbench/reference/tri.py``, one view at a time, following the
program's state), under the cell's limits; the run table holding more
than the JAX package's 2^21-row ceiling (counter ``tri.runs``) with no
overflow; each kernel launched in the eager step and at the capture, and
not in the replay. And a captured step's ``steps`` at a small scene of
tall thin triangles, whose runs outgrow the run table while the key slots
hold every pair: one warning, naming the run table and its setting.

Marked ``gpu``; skips without a CUDA device. This file imports no JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_tri_b8.py
"""

import gc
import sys
import warnings
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.gpu

PORTBENCH = Path(__file__).resolve().parents[1] / "portbench"
CELL = "tri100k_train_b8"
JAX_CEILING = (1 << 21) - 128  # the JAX package's run-table rows at most
SEED = 2 ** 31 + 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches():
    from dmesh_renderer_tpu_torch.ops import reduce as rd
    from dmesh_renderer_tpu_torch.ops import tri_binned as tb

    return (tb.fwd_composite.launches, tb.bwd_composite.launches,
            rd.seg_sum.launches)


def test_captured_b8_step_matches_the_reference(cuda):
    sys.path.insert(0, str(PORTBENCH))
    from harness import compare, spec
    from harness.program import TrainProgram, build_kernels
    from harness.scenes import make_scene, make_views

    from dmesh_renderer_tpu_torch.utils import diagnostics

    bench = spec.load_benchmark()
    w = spec.cell(bench, CELL)
    cfg, tr = spec.config(bench, w["config"]), spec.traffic(w["traffic"])
    B = int(tr["views_per_step"])
    assert B == int(tr["view_pool"]) == int(cfg["views_per_step"]) == 8
    build_kernels()
    diagnostics.enable_spans()
    try:
        scene, gen = make_scene(cfg, SEED, cuda)
        views = make_views(cfg, scene, gen, B, targets=True)
        prog = TrainProgram(cfg, scene)
        batch = prog.batch(views)
        m, v = prog.moments()
        got = {"losses": [], "params": [prog.params()], "m": [m], "v": [v]}
        launched = []
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*overflow")
            for _ in range(int(tr["reference_steps"])):
                before = _launches()
                got["losses"].append(float(prog(batch)))
                launched.append(tuple(a - b for a, b in
                                      zip(_launches(), before)))
                got["params"].append(prog.params())
                m, v = prog.moments()
                got["m"].append(m)
                got["v"].append(v)
        step = prog.step
        assert step.captures == 1 and step.replays == 2
        (graph,) = step._graphs.values()
        assert not bool(graph.aux[0])
        runs_of_last = int(graph.aux[2])
        rep = diagnostics.span_report()
        runs = rep["counters"]["tri.runs"]["values"]
        caps = rep["counters"]["tri.runs.capacity"]["values"]
    finally:
        diagnostics.enable_spans(False)
    # K1 and K2 once, seg_sum twice (records, vertices): in the eager step
    # and at the capture; the replay launches nothing through a wrapper
    assert launched == [(1, 1, 2), (1, 1, 2), (0, 0, 0)]
    assert len(runs) == 3 and all(JAX_CEILING < r <= c
                                  for r, c in zip(runs, caps))
    assert runs_of_last == runs[-1]
    assert caps == [4 * B * int(cfg["faces"])] * 3
    del prog, step, graph
    gc.collect()
    torch.cuda.empty_cache()
    numbers = compare.train_followed(cfg, scene, got, [views] * len(runs))
    ok, compared = compare.judge(numbers, spec.limits(CELL))
    assert ok, compared


def test_captured_steps_warn_of_the_run_table(cuda):
    """8 views of 64 vertical slivers, 1.8 high and 0.01 wide, at 256x256:
    ~7 tile rows and ~7 tiles a face, so the heuristic's 4 runs a face
    overflow and its 16 key slots a face do not. ``steps`` (the eager
    step, the capture and its replay, a replay) reads the flags once and
    warns once, with the run count."""
    import numpy as np

    from dmesh_renderer_tpu_torch.models import dmesh
    from dmesh_renderer_tpu_torch.ops import binning, geometry
    from dmesh_renderer_tpu_torch.utils.scenes import tri_scene

    B, F, size = 8, 64, 256
    _v, faces, vc, fo, mv, proj, vd, fi = tri_scene(F, B, size, size, 4)
    rng = np.random.RandomState(4)
    x, z, turn = rng.uniform(-0.5, 0.5, size=(3, F, 1))
    width = 0.01 * np.concatenate([0 * turn, np.cos(turn), 0 * turn], 1)
    verts = np.stack([x + width, np.broadcast_to([-0.9, -0.9, 0.9], (F, 3)),
                      z + width * np.tan(turn)], -1)
    user = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(cuda)
            for a in (verts.reshape(-1, 3), vc, fo, mv, proj, vd, fi)]
    verts, vc, fo, mv, proj, vd, fi = user
    faces = torch.from_numpy(faces).to(cuda)
    mv_t = mv.transpose(1, 2).contiguous()
    proj_t = proj.transpose(1, 2).contiguous()
    inv = geometry.inverse44(torch.stack([mv_t, proj_t]))
    batch = dmesh.ViewBatch(mv_t, proj_t, inv[0], inv[1], vd, fi,
                            torch.full((B, 3, size, size), 0.5, device=cuda))
    state = dmesh.init_train_state(
        dmesh.TriScene(*(t.clone().requires_grad_(True)
                         for t in (verts, vc, fo))),
        lambda p: torch.optim.Adam(p, lr=1e-2, capturable=True))
    step = dmesh.make_train_step(faces, torch.zeros(3, device=cuda), size,
                                 size, force="binned")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        losses = step.steps(state, batch, 3)
    assert (step.captures, step.replays) == (1, 2)
    assert bool(torch.isfinite(losses).all())
    kcap = binning.default_key_capacity(B, F)
    rows = binning.run_capacity(B * F, kcap)
    (msg,) = [str(r.message) for r in rec if "overflow" in str(r.message)]
    assert msg.startswith("dmesh_renderer_tpu_torch (render_tri_binned; "
                          "raise TriRenderSettings.run_capacity): "
                          "tile-binning run table overflow (")
    assert f"runs emitted > capacity {rows} rows)" in msg
    assert "key capacity" not in msg
    runs = int(msg.split("run table overflow (")[1].split(" ")[0])
    assert rows < runs
