"""The torch port's tri forward (plain composite, binned path, dense
oracle) against the JAX package and its goldens, on CPU.

Tolerances: the composite's C/D/T/prevT within 1e-5 absolute of JAX's
Pallas kernel (interpret mode; the f32 ops differ only where XLA contracts
a*b+c into an FMA), n_contrib exactly; the oracle within 1e-5 relative of
``golden/tri_scene.npz``; binned and oracle within ``FWD_ATOL`` 3e-5 of
``golden/tri_adversarial.npz`` outside the coverage flips that golden
carries from its jit compilation (see ``test_adversarial_golden``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dmesh_renderer_tpu.ops.tri_binned as jtb
from dmesh_renderer_tpu_torch.convert import tri_inputs_from_numpy
from dmesh_renderer_tpu_torch.ops import binning as tb
from dmesh_renderer_tpu_torch.ops import geometry as tg
from dmesh_renderer_tpu_torch.ops import rays as tr
from dmesh_renderer_tpu_torch.ops import tri_binned as ttb
from dmesh_renderer_tpu_torch.ops.tri_oracle import render_tri_oracle
import scenes
import test_golden
import test_golden_adversarial as tga
from test_torch_geometry import jax_geometry, scene

KCAP = 8192
FWD_ATOL = tga.FWD_ATOL
# Adversarial-golden pixels off by more than FWD_ATOL: the coverage flips
# the golden's jit compilation carries (see test_adversarial_golden). The
# count is what the CPU run shows, 3 of 64x64; against JAX with the
# projection rounded op by op the same scene matches everywhere
# (test_plain_composite_matches_jax_kernel[adversarial]).
MAX_FLIP_PIXELS = 3


def port_composite(t, h, w, kcap=KCAP):
    """The port's binned pipeline up to the plain composite."""
    B = t[4].shape[0]
    gx, gy = (w + 31) // 32, (h + 31) // 32
    ndc, img = tg.project_verts(t[0], t[4], t[5], w, h)
    pre = tg.preprocess_faces(ndc, img, t[1], w, h, 32, 32)
    keys = tb.emit_and_sort(pre, gx, gy, kcap, tile_px=32)
    ff, fi = ttb.build_face_table(t[0], t[1], t[2], t[3], t[8], t[9], img,
                                  t[6][:, 3, :3])
    _ro, rd = tr.generate_rays(t[6], t[7], w, h)
    inputs = (keys.starts, keys.ends, keys.slot_face, ff[keys.sigma],
              fi[keys.sigma], rd, B, h, w)
    return inputs, ttb.fwd_composite_plain(*inputs)


@pytest.mark.parametrize("name", ["golden", "binned_fixture", "adversarial"])
def test_plain_composite_matches_jax_kernel(name, monkeypatch):
    a, t, h, w = scene(name)
    B = a[4].shape[0]
    gx, gy = (w + 31) // 32, (h + 31) // 32
    # JAX's binned forward with its projection taken eagerly (see
    # test_torch_geometry) and the rest, Pallas kernel included, under jit
    ndc, img, _pre = jax_geometry(name)
    monkeypatch.setattr(jtb, "project_verts", lambda *_a, **_k: (ndc, img))
    color, depth, st = jax.jit(
        lambda *x: jtb._render_binned_impl(*x, h, w, KCAP)[:3])(
        *map(jnp.asarray, a))
    st = np.asarray(jtb._untile(st, B, h, w, gx, gy))

    _inputs, (C, D, T, pT, nc) = port_composite(t, h, w)
    bg = t[10]
    np.testing.assert_allclose((C + T[:, None] * bg[:, None, None]).numpy(),
                               np.asarray(color), rtol=0, atol=1e-5)
    np.testing.assert_allclose((D + T)[:, None].numpy(), np.asarray(depth),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(T.numpy(), st[..., 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(pT.numpy(), st[..., 1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(nc.numpy(), st[..., 2].astype(np.int32))
    assert int(nc.max()) > 1


def test_fwd_composite_on_cpu_runs_plain():
    _a, t, h, w = scene("binned_fixture")
    inputs, want = port_composite(t, h, w)
    before = ttb.fwd_composite.launches
    got = ttb.fwd_composite(*inputs)
    assert ttb.fwd_composite.launches == before  # no kernel on the CPU
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    bad = list(inputs)
    bad[3] = bad[3].double()
    with pytest.raises(TypeError):
        ttb.fwd_composite(*bad)
    with pytest.raises(ValueError):
        ttb.fwd_composite(*inputs[:6], inputs[6], h + 1, w)


def test_oracle_matches_golden():
    golden = dict(np.load(test_golden.GOLDEN))
    _a, t, h, w = scene("golden")
    color, depth = render_tri_oracle(*t, h, w)
    for k, got in (("color", color), ("depth", depth)):
        want = golden[k]
        err = np.abs(got.numpy() - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-5, f"{k}: rel Linf {err}"


def test_adversarial_golden():
    """Binned and oracle agree everywhere; against the golden they agree
    outside isolated coverage flips. The golden was rendered under jit,
    where XLA:CPU contracts the projection's a*b+c into FMAs and so moves
    a few fixed-point vertex coordinates by one unit (the port rounds every
    op, as the JAX source is written): pixel samples on such an edge flip.
    """
    golden = dict(np.load(tga.GOLDEN))
    _a, t, h, w = scene("adversarial")
    binned = ttb.render_tri_binned(*t, h, w, 1 << 14)
    oracle = render_tri_oracle(*t, h, w)
    for k, b, o in zip(("color", "depth"), binned, oracle):
        np.testing.assert_allclose(b.numpy(), o.numpy(), rtol=0,
                                   atol=FWD_ATOL)
        off = np.abs(b.numpy() - golden[k]) > FWD_ATOL
        n_off = int(off.any(axis=1).sum())
        assert n_off <= MAX_FLIP_PIXELS, f"{k}: {n_off} pixels off"


def test_binned_matches_oracle_midsize():
    soup = scenes.random_triangle_soup(600, seed=5)
    mv, proj = scenes.ring_cameras(2, radius=3.0)
    vd, fi = scenes.soup_view_attrs(soup, 2, seed=6)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    t = tri_inputs_from_numpy(
        soup["verts"], soup["faces"], soup["verts_color"],
        soup["faces_opacity"], mv_t, proj_t, np.linalg.inv(mv_t),
        np.linalg.inv(proj_t), vd, fi, [0.3, 0.2, 0.1], device="cpu")
    h, w = 72, 56
    cb, db, (ovf, n) = ttb.render_tri_binned(*t, h, w, None, True)
    co, do = render_tri_oracle(*t, h, w)
    assert not bool(ovf) and int(n) > 600
    np.testing.assert_allclose(cb.numpy(), co.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(db.numpy(), do.numpy(), rtol=0, atol=2e-5)


def test_near_plane_faces_match_oracle():
    _a, t, h, w = scene("near_plane")
    cb, db = ttb.render_tri_binned(*t, h, w)
    co, do = render_tri_oracle(*t, h, w)
    np.testing.assert_allclose(cb.numpy(), co.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(db.numpy(), do.numpy(), rtol=0, atol=2e-5)


def test_wrapped_coverage_outside_rect_not_rendered():
    """A face with a vertex just behind the w=0 plane wraps its int32 edge
    functions, and in_tri passes at pixels whose tile is outside its rect;
    neither path renders them (the scene of the JAX test of that name)."""
    tri = np.array(
        [[0.456025093793869, -0.7886804938316345, 0.6957451701164246],
         [4.529575347900391, -0.9736150503158569, -0.21224737167358398],
         [0.7446367144584656, -0.45834046602249146, 0.3057740330696106]],
        np.float32)
    mv_t = np.array(
        [[[0.29552021622657776, 0.19194255769252777,
           -0.9358556866645813, 0.0],
          [0.0, -0.979608416557312, -0.20091617107391357, 0.0],
          [-0.9553365111351013, 0.059374790638685226,
           -0.2894940972328186, 0.0],
          [2.2837982903534224e-16, -1.689350799580926e-17,
           3.981760025024414, 1.0]]], np.float32)
    proj_t = np.array(
        [[[2.4142136573791504, 0.0, 0.0, 0.0],
          [0.0, 2.4142136573791504, 0.0, 0.0],
          [0.0, 0.0, 1.0202020406723022, 1.0],
          [0.0, 0.0, -0.20202019810676575, 0.0]]], np.float32)
    h, w = 48, 40
    bg = np.array([0.3, 0.5, 0.7], np.float32)
    t = tri_inputs_from_numpy(
        tri, np.array([[0, 1, 2]], np.int32), np.eye(3, dtype=np.float32),
        np.array([0.745], np.float32), mv_t, proj_t, np.linalg.inv(mv_t),
        np.linalg.inv(proj_t), np.full((1, 3), 0.5, np.float32),
        np.ones((1, 1), np.float32), bg, device="cpu")
    _ndc, img = tg.project_verts(t[0], t[4], t[5], w, h)
    pre = tg.preprocess_faces(_ndc, img, t[1], w, h, 32, 32)
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                         indexing="ij")
    pix = torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], -1)
                           .astype(np.float32))
    cov = tg.in_tri(pix, img[0, 0], img[0, 1], img[0, 2]).reshape(h, w)
    py, px = np.where(cov.numpy())
    rmin, rmax = pre["rect_min"][0, 0].numpy(), pre["rect_max"][0, 0].numpy()
    outside = ((px // 32 < rmin[0]) | (px // 32 >= rmax[0])
               | (py // 32 < rmin[1]) | (py // 32 >= rmax[1]))
    assert outside.sum() > 0, "scene no longer exercises wrapped coverage"

    cb, db = ttb.render_tri_binned(*t, h, w)
    co, do = render_tri_oracle(*t, h, w)
    np.testing.assert_allclose(cb.numpy(), co.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(db.numpy(), do.numpy(), rtol=0, atol=2e-6)
    oy, ox = py[outside], px[outside]
    np.testing.assert_allclose(co.numpy()[0][:, oy, ox],
                               bg[:, None] * np.ones((3, len(oy))), atol=1e-6)
