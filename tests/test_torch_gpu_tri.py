"""The torch port's CUDA kernel on the card: K1 against its plain version,
and the binned forward on the card against the CPU and the golden.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX, so it runs where only PyTorch is installed:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_tri.py
"""

import os

import numpy as np
import pytest
import torch

from dmesh_renderer_tpu_torch import TriRenderSettings, TriRenderer
from dmesh_renderer_tpu_torch.convert import tri_inputs_from_numpy
from dmesh_renderer_tpu_torch.ops import binning as tb
from dmesh_renderer_tpu_torch.ops import geometry as tg
from dmesh_renderer_tpu_torch.ops import rays as tr
from dmesh_renderer_tpu_torch.ops import tri_binned as ttb
from dmesh_renderer_tpu_torch.ops.tri import render_tri_auto
import scenes

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tri_scene.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _soup_args(n_tris, n_views, seed, bg=(0.15, 0.25, 0.35), radius=3.0):
    soup = scenes.random_triangle_soup(n_tris, seed=seed)
    mv, proj = scenes.ring_cameras(n_views, radius=radius)
    vd, fi = scenes.soup_view_attrs(soup, n_views, seed=seed + 1)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    return (soup["verts"], soup["faces"], soup["verts_color"],
            soup["faces_opacity"], mv_t, proj_t, np.linalg.inv(mv_t),
            np.linalg.inv(proj_t), vd, fi, np.asarray(bg, np.float32))


# (n_tris, views, seed, H, W): the golden scene, the binned-test fixture
# (48x40), an image that is no multiple of 16 (33x40), a mid-size scene
CASES = {
    "golden": (16, 2, 42, 32, 32),
    "binned_fixture": (24, 2, 13, 48, 40),
    "odd_33x40": (60, 1, 102, 33, 40),
    "mid_600": (600, 2, 5, 72, 56),
    # lists of ~1,500-3,000 slots per 32x32 tile: many of the kernel's
    # 32-slot rounds, pixels that finish mid-round and at a round's end
    "many_rounds": (4096, 2, 7, 64, 64),
}
ROUND = 32  # the kernel's slots per staged round (csrc/tri_fwd.cu kRound)


def _composite_inputs(t, h, w):
    B = t[4].shape[0]
    gx, gy = (w + 31) // 32, (h + 31) // 32
    ndc, img = tg.project_verts(t[0], t[4], t[5], w, h)
    pre = tg.preprocess_faces(ndc, img, t[1], w, h, 32, 32)
    keys = tb.emit_and_sort(pre, gx, gy, 8192, tile_px=32)
    ff, fi = ttb.build_face_table(t[0], t[1], t[2], t[3], t[8], t[9], img,
                                  t[6][:, 3, :3])
    rd = tr.generate_rays(t[6], t[7], w, h)[1]
    return (keys.starts, keys.ends, keys.slot_face, ff[keys.sigma],
            fi[keys.sigma], rd, B, h, w)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(case, cuda):
    n, b, seed, h, w = CASES[case]
    t = tri_inputs_from_numpy(*_soup_args(n, b, seed), device=cuda)
    inputs = _composite_inputs(t, h, w)
    before = ttb.fwd_composite.launches
    got = ttb.fwd_composite(*inputs)
    torch.cuda.synchronize()
    assert ttb.fwd_composite.launches == before + 1
    want = ttb.fwd_composite_plain(*inputs)
    for g, p in zip(got[:4], want[:4]):
        assert float((g - p).abs().max()) <= 1e-5
    assert torch.equal(got[4], want[4])


def test_binned_on_card_matches_cpu_and_golden(cuda):
    args = _soup_args(16, 2, 42, bg=(0.2, 0.1, 0.3))
    golden = dict(np.load(GOLDEN))
    tc = tri_inputs_from_numpy(*args, device=cuda)
    tcpu = tri_inputs_from_numpy(*args, device="cpu")
    cb, db = render_tri_auto(*tc, 32, 32, force="binned")
    cc, dc = render_tri_auto(*tcpu, 32, 32, force="binned")
    co, do = render_tri_auto(*tc, 32, 32, force="oracle")
    for got, ref, key in ((cb, cc, "color"), (db, dc, "depth")):
        assert float((got.cpu() - ref).abs().max()) <= 1e-5
        want = golden[key]
        rel = np.abs(got.cpu().numpy() - want).max() / max(
            1.0, np.abs(want).max())
        assert rel < 1e-4, (key, rel)
    assert float((cb - co).abs().max()) <= 2e-5
    assert float((db - do).abs().max()) <= 2e-5


def test_trirenderer_on_card(cuda):
    soup = scenes.random_triangle_soup(5000, seed=9)
    mv, proj = scenes.ring_cameras(2)
    vd, fi = scenes.soup_view_attrs(soup, 2, seed=10)
    user = (soup["verts"], soup["faces"], soup["verts_color"],
            soup["faces_opacity"], mv, proj, vd, fi)
    settings = TriRenderSettings(96, 80, np.array([0.1, 0.2, 0.3],
                                                  np.float32))
    before = ttb.fwd_composite.launches
    c, d, (ovf, n) = TriRenderer(settings, device="cuda")(
        *user, return_aux=True)
    assert ttb.fwd_composite.launches == before + 1
    cc, dc, (ovf_c, n_c) = TriRenderer(settings, device="cpu")(
        *user, return_aux=True)
    assert (bool(ovf), int(n)) == (bool(ovf_c), int(n_c))
    assert float((c.cpu() - cc).abs().max()) <= 1e-4
    assert float((d.cpu() - dc).abs().max()) <= 1e-4


def _assert_bit_equal(got, want):
    for g, p in zip(got, want):
        assert torch.equal(g, p)


def test_kernel_round_edges(cuda):
    """K1 bit-equal to its plain version where every tile list spans more
    than two rounds: pixels that finish inside a round, at a round's last
    slot, after the second round, and never."""
    n, b, seed, h, w = CASES["many_rounds"]
    t = tri_inputs_from_numpy(*_soup_args(n, b, seed), device=cuda)
    inputs = _composite_inputs(t, h, w)
    got = ttb.fwd_composite(*inputs)
    torch.cuda.synchronize()
    want = ttb.fwd_composite_plain(*inputs)
    _assert_bit_equal(got, want)
    count = inputs[1] - inputs[0]
    assert int(count.min()) > 2 * ROUND
    _C, _D, T, _pT, nc = want
    finished = T < 1e-4
    assert int((finished & (nc % ROUND == 0)).sum()) > 0
    assert int((finished & (nc % ROUND != 0)).sum()) > 0
    assert int((nc > 2 * ROUND).sum()) > 0
    assert int((~finished).sum()) > 0


def test_kernel_empty_tile_list(cuda):
    """A tile whose list is empty (and a neighbour's that is one slot
    long) among long ones: its pixels keep T = 1 and n_contrib 0."""
    n, b, seed, h, w = CASES["many_rounds"]
    t = tri_inputs_from_numpy(*_soup_args(n, b, seed), device=cuda)
    starts, ends, *rest = _composite_inputs(t, h, w)
    ends = ends.clone()
    ends[0] = starts[0]
    ends[1] = starts[1] + 1
    inputs = (starts, ends, *rest)
    got = ttb.fwd_composite(*inputs)
    torch.cuda.synchronize()
    want = ttb.fwd_composite_plain(*inputs)
    _assert_bit_equal(got, want)
    _C, _D, T, _pT, nc = got
    assert bool((T[0, :32, :32] == 1).all() and (nc[0, :32, :32] == 0).all())
    assert int(nc[0, :32, 32:64].max()) <= 1
