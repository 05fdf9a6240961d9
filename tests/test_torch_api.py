"""The torch port's public API against the JAX package's, on CPU.

``TriRenderer``/``render_tri`` with torch CPU tensors and ``device="cpu"``
must match the JAX package's within 1e-4 relative (the tolerance of
test_golden.py for the binned path), aux outputs included; empty geometry,
casts, shape errors and the CUDA request behave as specified, and the
gradients match the JAX package's torch bridge.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dmesh_renderer_tpu as jdr
from dmesh_renderer_tpu.ops import binning as jb
from dmesh_renderer_tpu.validation import check_tri_inputs as jax_check
import dmesh_renderer_tpu_torch as tdr
import dmesh_renderer_tpu_torch.ops.tri as ttri
from dmesh_renderer_tpu_torch.convert import outputs_to_numpy
from dmesh_renderer_tpu_torch.ops import binning as tb
from dmesh_renderer_tpu_torch.ops import geometry as tg
import scenes
from test_torch_geometry import jax_geometry, scene

H, W, B = 40, 36, 2
BG = np.array([0.2, 0.3, 0.4], np.float32)


@pytest.fixture(scope="module")
def soup():
    s = scenes.random_triangle_soup(40, seed=3)
    mv, proj = scenes.ring_cameras(B)
    vd, fi = scenes.soup_view_attrs(s, B, seed=4)
    return (s["verts"], s["faces"], s["verts_color"], s["faces_opacity"],
            mv, proj, vd, fi)


def _torch(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def test_trirenderer_matches_jax(soup):
    settings = jdr.TriRenderSettings(H, W, BG)
    c_j, d_j = jdr.TriRenderer(settings)(*soup)
    r = tdr.TriRenderer(tdr.TriRenderSettings(H, W, torch.from_numpy(BG)),
                        device="cpu")
    out = r(*_torch(soup))
    assert out[0].device.type == "cpu" and out[0].dtype == torch.float32
    c_t, d_t = outputs_to_numpy(out)
    assert c_t.shape == (B, 3, H, W) and d_t.shape == (B, 1, H, W)
    assert _rel(c_t, c_j) <= 1e-4 and _rel(d_t, d_j) <= 1e-4
    # the oracle path's aux, through render_tri with transposed matrices
    mv_t, proj_t = (np.swapaxes(m, 1, 2) for m in soup[4:6])
    args = soup[:4] + (mv_t, proj_t) + soup[6:]
    *_j, (ovf_j, n_j) = jdr.render_tri(*args, settings, return_aux=True)
    *_t, (ovf_t, n_t) = tdr.render_tri(*_torch(args), settings,
                                       return_aux=True, device="cpu")
    assert (bool(ovf_t), int(n_t)) == (bool(ovf_j), int(n_j)) == (False, -1)


@pytest.mark.parametrize("key_capacity", [None, 16])
def test_binned_render_tri_aux_matches_jax(key_capacity, monkeypatch):
    """Through the binned path (thresholds at 0), render_tri's
    ``(overflow, num_rendered)`` equal JAX's binning under the same
    capacity -- including a capacity that drops pairs -- and the image
    matches the port's oracle where nothing is dropped."""
    name = "binned_fixture"
    a, t, h, w = scene(name)
    monkeypatch.setattr(ttri, "BINNED_THRESHOLD_CPU", 0)
    settings = tdr.TriRenderSettings(h, w, t[10], key_capacity)
    cb, db, (ovf, n) = tdr.render_tri(*t[:6], t[8], t[9], settings,
                                      return_aux=True, device="cpu")
    kcap = jb.default_key_capacity(B, 24) if key_capacity is None \
        else key_capacity
    _ndc, _img, pre = jax_geometry(name)
    keys = jax.jit(lambda p: jb.emit_and_sort(
        p, 2, 2, kcap, tile_px=32))(pre)
    assert (bool(ovf), int(n)) == (bool(keys.overflow), int(keys.total))
    assert bool(ovf) == (key_capacity == 16)
    if key_capacity is None:
        monkeypatch.setattr(ttri, "BINNED_THRESHOLD_CPU", 4096)
        co, do = tdr.render_tri(*t[:6], t[8], t[9], settings, device="cpu")
        assert _rel(cb.numpy(), co.numpy()) <= 1e-4
        assert _rel(db.numpy(), do.numpy()) <= 1e-4


def test_empty_geometry(soup):
    settings = tdr.TriRenderSettings(H, W, BG)
    v, f, vc, fo, mv, proj, vd, fi = _torch(soup)
    r = tdr.TriRenderer(settings, device="cpu")
    c, d, (ovf, n) = r(v[:0], f[:0], vc[:0], fo[:0], mv, proj, vd[:, :0],
                       fi[:, :0], return_aux=True)
    assert not c.any() and not d.any() and c.shape == (B, 3, H, W)
    assert (bool(ovf), int(n)) == (False, 0)
    c, d = r(v, f[:0], vc, fo[:0], mv, proj, vd, fi[:, :0])
    np.testing.assert_array_equal(
        c.numpy(), np.broadcast_to(BG[None, :, None, None], c.shape))
    np.testing.assert_array_equal(d.numpy(), np.ones(d.shape, np.float32))


def test_faces_int64_and_shape_errors(soup):
    settings = tdr.TriRenderSettings(H, W, BG)
    r = tdr.TriRenderer(settings, device="cpu")
    args = _torch(soup)
    c32, d32 = r(*args)
    c64, d64 = r(args[0], args[1].long(), *args[2:])
    assert torch.equal(c32, c64) and torch.equal(d32, d64)

    mv_t, proj_t = (np.swapaxes(m, 1, 2) for m in soup[4:6])
    bad = soup[:2] + (soup[2][:-1], soup[3], mv_t, proj_t, soup[6],
                      soup[7], BG)
    with pytest.raises(ValueError) as jerr:
        jax_check(*(jnp.asarray(x) for x in bad))
    with pytest.raises(ValueError) as terr:
        r(*args[:2], args[2][:-1], *args[3:])
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="faces_intense must be"):
        r(*args[:7], args[7][:1])


@pytest.mark.parametrize("strategy", ["oracle", "binned"])
def test_grads_match_jax_torch_bridge(soup, strategy, monkeypatch):
    """The same torch leaf tensors through the JAX package's TriRenderer
    (its torch autograd bridge) and the port's, the same loss, then
    ``.backward()``: the five ``.grad`` agree within 1e-4 relative, and
    faces and the matrices get none. ``binned`` sets both dispatch
    thresholds to 0 (and a key capacity, so that the bridge traces anew)."""
    kcap = None
    if strategy == "binned":
        import dmesh_renderer_tpu.ops.tri as jtri

        kcap = 8192
        monkeypatch.setattr(jtri, "BINNED_THRESHOLD_CPU", 0)
        monkeypatch.setattr(ttri, "BINNED_THRESHOLD_CPU", 0)
    rng = np.random.RandomState(17)
    wc = torch.from_numpy(rng.randn(B, 3, H, W).astype(np.float32))
    wd = torch.from_numpy(rng.randn(B, 1, H, W).astype(np.float32))
    grads = []
    for pkg in (jdr, tdr):
        args = _torch(soup)
        args[1] = args[1].long()
        for i in (0, 2, 3, 6, 7):
            args[i].requires_grad_(True)
        args[4].requires_grad_(pkg is tdr)  # a matrix: no gradient
        settings = pkg.TriRenderSettings(H, W, BG, kcap)
        kw = {"device": "cpu"} if pkg is tdr else {}
        c, d = pkg.TriRenderer(settings, **kw)(*args)
        ((c * wc).sum() + (d * d * wd).sum()).backward()
        grads.append([args[i].grad for i in (0, 2, 3, 6, 7)])
        if pkg is tdr:
            assert args[4].grad is None
    for gj, gt in zip(*grads):
        assert gt is not None and gt.shape == gj.shape
        assert _rel(gt.numpy(), gj.numpy()) <= 1e-4
    assert any(bool(g.any()) for g in grads[1])


def test_cuda_without_card_raises(soup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = tdr.TriRenderSettings(H, W, BG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr.TriRenderer(settings)
    mv_t, proj_t = (np.swapaxes(m, 1, 2) for m in soup[4:6])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr.render_tri(*soup[:4], mv_t, proj_t, *soup[6:], settings)


def test_geometry_helpers_device_agnostic():
    """The saturating cast and int32 wrap are pure tensor ops (no host
    round trip), so they run unchanged on the card."""
    x = torch.tensor([2.0 ** 31, -(2.0 ** 32), float("nan"), 5.9])
    assert tg.sat_i32(x).tolist() == [2**31 - 1, -(2**31), 0, 5]
    w = tg.wrap_i32(torch.tensor([2**31, -(2**31) - 1, 2**32 + 7]))
    assert w.tolist() == [-(2**31), 2**31 - 1, 7]
    assert tb.default_key_capacity(1, 100_000) == 1_600_000


def test_top_level_names_match_jax():
    """The port exports the JAX package's three other top-level names: the
    key-capacity helper, the tet connectivity function and the version."""
    for name in ("recommended_key_capacity", "build_tet_connectivity",
                 "__version__"):
        assert name in tdr.__all__ and hasattr(jdr, name)
    assert tdr.__version__ == jdr.__version__ == "0.1.0"
    assert tdr.recommended_key_capacity is tb.recommended_key_capacity
    tets = np.array([[0, 1, 2, 3], [1, 2, 3, 4]], np.int32)
    for got, want in zip(tdr.build_tet_connectivity(tets),
                         jdr.build_tet_connectivity(tets)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
