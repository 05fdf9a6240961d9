"""The card's dispatch thresholds: on each side of ``BINNED_THRESHOLD_GPU``
the tri renderer takes the dense oracle (no K1 launch) or the binned path
(K1 once), and on each side of ``BINNED_FIRST_HIT_THRESHOLD_GPU`` the tet
renderer takes the dense first hit (no K3 launch) or the binned one (K3
once). The CPU keeps the JAX package's values, which its parity tests
depend on.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_dispatch.py
"""

import numpy as np
import pytest
import torch

from dmesh_renderer_tpu_torch import TetRenderSettings, TetRenderer
from dmesh_renderer_tpu_torch.ops import tet as pt
from dmesh_renderer_tpu_torch.ops import tet_first_hit as pfh
from dmesh_renderer_tpu_torch.ops import tri as ptri
from dmesh_renderer_tpu_torch.ops import tri_binned as tb
from dmesh_renderer_tpu_torch.utils.connectivity import (
    build_tet_connectivity, freudenthal_grid,
)
from dmesh_renderer_tpu_torch.utils.scenes import tet_scene, tri_scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cpu_values_unchanged():
    assert (ptri.BINNED_THRESHOLD_CPU, pt.BINNED_FIRST_HIT_THRESHOLD) == (
        4096, 2048)


def _tri_launches(n_faces, dev):
    """K1 launches of one ``render_tri_auto`` call on ``n_faces`` faces."""
    v, f, vc, fo, mv, proj, vd, fi = tri_scene(max(n_faces, 1), 1, 64, 64,
                                               seed=4)
    f, fo, fi = f[:n_faces], fo[:n_faces], fi[:, :n_faces]
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        v, f, vc, fo, mv_t, proj_t, np.linalg.inv(mv_t),
        np.linalg.inv(proj_t), vd, fi, np.zeros(3, np.float32))]
    before = tb.fwd_composite.launches
    c, _d = ptri.render_tri_auto(*args, 64, 64)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(c).all())
    return tb.fwd_composite.launches - before


def test_tri_threshold_sides(cuda):
    thr = ptri.BINNED_THRESHOLD_GPU
    assert _tri_launches(thr, cuda) == 0
    assert _tri_launches(thr + 1, cuda) == 1


def _grid_faces(n):
    return build_tet_connectivity(freudenthal_grid(n, 0.15, 2)[1])[0].shape[0]


def test_tet_threshold_sides(cuda):
    """The Freudenthal grids next to the value on either side (the value
    was read from a ladder of these grids): the largest at or below it
    takes the dense first hit, the smallest above it the binned one. With
    the value 0 no grid lies below it: a scene without tets casts no ray
    at all, and the smallest grid (18 faces) takes K3."""
    thr = pt.BINNED_FIRST_HIT_THRESHOLD_GPU
    grids = {n: _grid_faces(n) for n in range(1, 11)}
    below = [n for n, f in grids.items() if f <= thr]
    above = [n for n, f in grids.items() if f > thr]
    assert above, "the value lies above every grid of the ladder"
    cases = [(max(below) if below else None, 0), (min(above), 1)]
    for n, want in cases:
        *inputs, bg = tet_scene(n or 1, 1, 64, 64)
        if n is None:  # no tets
            inputs[8], inputs[10] = inputs[8][:0], inputs[10][:0]
        r = TetRenderer(TetRenderSettings(64, 64, bg), device="cuda")
        before = pfh.first_hit.launches
        _c, _d, active = r(*inputs)
        torch.cuda.synchronize()
        assert pfh.first_hit.launches - before == want, (n, thr)
        assert bool(active.any()) == (n is not None)


@pytest.mark.parametrize("n_grid", [1, 2])
def test_tet_card_reads_its_own_value(n_grid, cuda):
    """A grid of 18 or 120 faces lies at or below the CPU's value and above
    the card's: the card renders it with K3 once, so the device type, not
    the CPU's value, chose the path."""
    n_faces = _grid_faces(n_grid)
    assert (pt.BINNED_FIRST_HIT_THRESHOLD_GPU < n_faces
            <= pt.BINNED_FIRST_HIT_THRESHOLD), n_faces
    *inputs, bg = tet_scene(n_grid, 1, 64, 64)
    before = pfh.first_hit.launches
    _c, _d, active = TetRenderer(TetRenderSettings(64, 64, bg),
                                 device="cuda")(*inputs)
    torch.cuda.synchronize()
    assert pfh.first_hit.launches - before == 1
    assert bool(active.any())


def test_tri_binned_with_every_face_culled(cuda):
    """Above the value a scene whose faces all lie off the image takes the
    binned path with empty tile lists: the background, depth 1, and zero
    gradients, as the oracle gives."""
    v, f, vc, fo, mv, proj, vd, fi = tri_scene(3, 1, 64, 64, seed=4)
    assert f.shape[0] > ptri.BINNED_THRESHOLD_GPU
    v = v + np.array([50.0, 50.0, 0.0], np.float32)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in (
        v, f, vc, fo, mv_t, proj_t, np.linalg.inv(mv_t),
        np.linalg.inv(proj_t), vd, fi, np.full(3, 0.25, np.float32))]
    out = {}
    for force in (None, "oracle"):
        leaves = [args[i].clone().requires_grad_(True)
                  for i in (0, 2, 3, 8, 9)]
        before = tb.fwd_composite.launches
        c, d = ptri.render_tri_auto(leaves[0], args[1], leaves[1], leaves[2],
                                    *args[4:8], leaves[3], leaves[4], args[10],
                                    64, 64, force=force)
        (c.sum() + d.sum()).backward()
        torch.cuda.synchronize()
        assert tb.fwd_composite.launches - before == (force is None)
        out[force] = (c, d, [x.grad for x in leaves])
    c, d, grads = out[None]
    assert bool((c == 0.25).all() and (d == 1.0).all())
    assert all(not bool(g.any()) for g in grads)
    assert torch.equal(c, out["oracle"][0])
    assert torch.equal(d, out["oracle"][1])
