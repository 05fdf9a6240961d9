"""The port's ``utils/diagnostics`` against the JAX package's, on CPU: the
scenes of ``tests/test_diagnostics.py`` through both packages.
``tri_render_stats`` and ``tet_health`` give equal dicts; ``StageTimer``
accumulates; ``trace`` writes a Chrome trace."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dmesh_renderer_tpu.utils import diagnostics as jd
from dmesh_renderer_tpu_torch.utils import diagnostics as pd
import scenes


def test_tri_render_stats_match_jax():
    soup = scenes.random_triangle_soup(30, seed=9)
    mv, proj = scenes.ring_cameras(2)
    size = 64
    mv_t = np.ascontiguousarray(np.swapaxes(mv, 1, 2))
    proj_t = np.ascontiguousarray(np.swapaxes(proj, 1, 2))
    want = jd.tri_render_stats(
        jnp.asarray(soup["verts"]), jnp.asarray(soup["faces"]),
        jnp.asarray(mv_t), jnp.asarray(proj_t), size, size)
    got = pd.tri_render_stats(
        torch.from_numpy(soup["verts"]), torch.from_numpy(soup["faces"]),
        torch.from_numpy(mv_t), torch.from_numpy(proj_t), size, size)
    assert got == want
    assert got["num_rendered"] > 0 and not got["overflow"]
    assert got["tile_count_max"] >= got["tile_count_mean"] > 0
    # a capacity below the pairs overflows in both
    small = pd.tri_render_stats(
        torch.from_numpy(soup["verts"]), torch.from_numpy(soup["faces"]),
        torch.from_numpy(mv_t), torch.from_numpy(proj_t), size, size,
        kcap=got["num_rendered"] - 1)
    assert small["overflow"] and small["key_capacity"] == \
        got["num_rendered"] - 1


def test_tet_health_matches_jax():
    rng = np.random.RandomState(4)
    for active in (np.zeros((2, 8, 8), bool), rng.rand(3, 5, 7) < 0.4):
        if not active.any():
            active[0, :4] = True
        got = pd.tet_health(torch.from_numpy(active))
        assert got == jd.tet_health(active)
    h = pd.tet_health(np.pad(np.ones((1, 4, 8), bool), ((0, 1), (0, 4),
                                                        (0, 0))))
    assert h["active_fraction_per_view"] == [0.5, 0.0]
    assert h["inactive_pixels"] == 96


def test_stage_timer_accumulates():
    t = pd.StageTimer("cpu")
    for _ in range(2):
        with t.stage("a"):
            torch.ones((64, 64)).sum()
    with t.stage("b"):
        pass
    assert set(t.times) == {"a", "b"} and t.times["a"] > 0
    assert "total" in t.summary()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pd.StageTimer()  # the card by default: no silent CPU timing


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with pd.trace(str(log_dir)) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    path = prof.trace_path
    assert os.path.dirname(path) == str(log_dir)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert pd.device_busy_ms(prof) == 0.0  # no device events on the CPU


def test_serve_frame_ms_on_cpu(capsys):
    """``tools/serve_frame_ms.py`` times both serving frames through the
    public API and prints one JSON line; the tet frame's active pixels
    equal those of ``TetRenderer`` on the same scene."""
    from dmesh_renderer_tpu_torch import TetRenderSettings, TetRenderer
    from dmesh_renderer_tpu_torch.tools import serve_frame_ms
    from dmesh_renderer_tpu_torch.utils.scenes import tet_scene

    out = serve_frame_ms.main(["--device", "cpu", "--reps", "2",
                               "--tri-faces", "60", "--tet-grid", "2",
                               "--size", "24"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["tri_faces"] == 60 and out["tet_faces"] == 120
    assert out["tri_frame_ms"] > 0 and out["tet_frame_ms"] > 0
    assert out["tri_syncs"] is None and out["tet_syncs"] is None
    *arrays, bg = tet_scene(2, 1, 24, 24)
    _c, _d, active = TetRenderer(TetRenderSettings(24, 24, bg),
                                 device="cpu")(*arrays)
    assert out["tet_active"] == int(active.sum()) > 0
