"""The torch port's geometry and rays against the JAX package, on CPU.

The scenes here (shared by the other ``test_torch_*`` files) are the JAX
tests' own: the binned-test fixture (48x40, B=2), the golden scene, the
near-plane scene and the adversarial golden scene. Inputs are NumPy arrays
fed bit-identically to both packages (``convert.tri_inputs_from_numpy``).

The JAX projection runs eagerly, op by op, as it is written: under jit,
XLA:CPU contracts its a*b+c into FMAs, which moves some fixed-point vertex
coordinates by one unit (the port, like the JAX source, rounds every op).
The stages after it hold no such pattern that changes these scenes'
results, so they run under jit, which keeps the tests fast.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dmesh_renderer_tpu.ops import geometry as jg
from dmesh_renderer_tpu.ops import rays as jr
from dmesh_renderer_tpu_torch.convert import tri_inputs_from_numpy
from dmesh_renderer_tpu_torch.ops import geometry as tg
from dmesh_renderer_tpu_torch.ops import rays as tr
import scenes
import test_golden
import test_golden_adversarial
import test_tri_binned


def _binned_fixture():
    """The fixture of test_tri_binned.py: 24 tris, 48x40, B=2."""
    soup = scenes.random_triangle_soup(24, seed=13)
    mv, proj = scenes.ring_cameras(2, radius=3.0)
    vdepth, fintense = scenes.soup_view_attrs(soup, 2, seed=14)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    args = (soup["verts"], soup["faces"], soup["verts_color"],
            soup["faces_opacity"], mv_t, proj_t, np.linalg.inv(mv_t),
            np.linalg.inv(proj_t), vdepth, fintense,
            np.array([0.15, 0.25, 0.35], np.float32))
    return args, 48, 40


def _near_plane():
    args, h, w = test_tri_binned._near_plane_scene()
    return tuple(np.asarray(a) for a in args), h, w


SCENES = {
    "binned_fixture": _binned_fixture,
    "golden": lambda: (tuple(np.asarray(a) for a in test_golden._args()),
                       test_golden.H, test_golden.W),
    "near_plane": _near_plane,
    "adversarial": lambda: (
        tuple(np.asarray(a) for a in test_golden_adversarial._scene_args()),
        test_golden_adversarial.H, test_golden_adversarial.W),
}


def scene(name):
    """(numpy args, torch CPU args, H, W) of a named scene."""
    args, h, w = SCENES[name]()
    return args, tri_inputs_from_numpy(*args, device="cpu"), h, w


@functools.lru_cache(maxsize=None)
def jax_geometry(name, tile=32):
    """JAX (ndc, img, pre) of a scene: eager projection, jitted
    preprocess."""
    a, h, w = SCENES[name]()
    ndc, img = jg.project_verts(jnp.asarray(a[0]), jnp.asarray(a[4]),
                                jnp.asarray(a[5]), w, h)
    pre = jax.jit(jg.preprocess_faces, static_argnums=(3, 4, 5, 6))(
        ndc, img, jnp.asarray(a[1]), w, h, tile, tile)
    return ndc, img, pre


def _eq(jax_val, torch_val):
    return np.array_equal(np.asarray(jax_val), torch_val.numpy())


def test_sat_i32_matches_xla_convert():
    x = np.array([3e9, -3e9, np.nan, np.inf, -np.inf, 2147483520.0,
                  -2147483648.0, 1.7, -1.7, 0.5, -0.5, 0.0], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = tg.sat_i32(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # what XLA gives, spelled out
    np.testing.assert_array_equal(want[:3], [2147483647, -2147483648, 0])


@pytest.mark.parametrize("name", ["binned_fixture", "adversarial"])
def test_project_verts_and_rays(name):
    a, t, h, w = scene(name)
    ndc, img, _pre = jax_geometry(name)
    tndc, timg = tg.project_verts(t[0], t[4], t[5], w, h)
    np.testing.assert_allclose(tndc.numpy(), np.asarray(ndc), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(timg.numpy(), np.asarray(img), rtol=1e-6,
                               atol=1e-6)
    ro, rd = jr.generate_rays(jnp.asarray(a[6]), jnp.asarray(a[7]), w, h)
    tro, trd = tr.generate_rays(t[6], t[7], w, h)
    np.testing.assert_allclose(trd.numpy(), np.asarray(rd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tro.numpy(), np.asarray(ro), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["binned_fixture", "near_plane",
                                  "adversarial"])
def test_preprocess_and_edge_coeffs_exact(name):
    """Rects, tiles, valid, depth keys and the int32 edge coefficients are
    bit-identical, near-plane faces whose coefficients wrap included."""
    a, t, h, w = scene(name)
    ndc, img, pre = jax_geometry(name)
    tndc, timg = tg.project_verts(t[0], t[4], t[5], w, h)
    assert _eq(ndc, tndc) and _eq(img, timg)
    tpre = tg.preprocess_faces(tndc, timg, t[1], w, h, 32, 32)
    for k in ("depth", "min_depth", "max_depth", "rect_min", "rect_max",
              "tiles", "valid", "nondeg"):
        assert _eq(pre[k], tpre[k]), k
    for k in ("edge_a", "edge_b", "edge_c"):
        for e in range(3):
            assert tpre[k][e].dtype == torch.int32
            assert _eq(pre[k][e], tpre[k][e]), (k, e)
    if name == "near_plane":
        # the scene reaches coefficients past 2^24 (f32-inexact)
        assert max(int(np.abs(np.asarray(x)).max())
                   for x in pre["edge_a"] + pre["edge_b"]) > 2**24


def test_in_tri_clamp_and_intersection():
    rng = np.random.RandomState(5)
    n = 4000
    # pixel-scale points plus near-plane-scale vertices that wrap int32
    p = rng.uniform(-4, 68, (n, 2)).astype(np.float32)
    tri = rng.uniform(-10, 74, (n, 3, 2)).astype(np.float32)
    tri[: n // 8] *= np.float32(3e6)
    tri[n // 8: n // 4, 1] = tri[n // 8: n // 4, 0]  # zero area
    want = jg.in_tri(*(jnp.asarray(x) for x in
                       (p, tri[:, 0], tri[:, 1], tri[:, 2])))
    got = tg.in_tri(*(torch.from_numpy(np.ascontiguousarray(x)) for x in
                      (p, tri[:, 0], tri[:, 1], tri[:, 2])))
    assert _eq(want, got) and 0 < int(got.sum()) < n

    u, v = np.meshgrid(np.linspace(-1.5, 2.5, 81, dtype=np.float32),
                       np.linspace(-1.5, 2.5, 81, dtype=np.float32))
    for jx, tx in zip(jg.clamp_bary_uv(jnp.asarray(u), jnp.asarray(v)),
                      tg.clamp_bary_uv(torch.from_numpy(u),
                                       torch.from_numpy(v))):
        assert _eq(jx, tx)

    o = rng.randn(n, 3).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    pts = rng.randn(3, n, 3).astype(np.float32)
    (jtuv, jnd) = jg.ray_tri_intersection(*(jnp.asarray(x) for x in
                                            (o, d, *pts)))
    (ttuv, tnd) = tg.ray_tri_intersection(*(torch.from_numpy(x) for x in
                                            (o, d, *pts)))
    assert _eq(jnd, tnd)
    np.testing.assert_allclose(ttuv.numpy(), np.asarray(jtuv), rtol=1e-4,
                               atol=1e-5)


def test_face_outward_normal_matches_jax():
    """``face_outward_normal`` against JAX's: the two cases of
    ``tests/test_geometry.py`` (centroid above and below the z = 0
    triangle), bit for bit; then random triangles and centroids within
    1e-6 (XLA:CPU contracts the cross product's a*b - c*d into FMAs, the
    port rounds both products), and zero-area triangles, whose normal is 0
    (their norm clamps at 1e-4)."""
    p0, p1, p2 = (np.array(x, np.float32) for x in
                  ([0, 0, 0], [1, 0, 0], [0, 1, 0]))
    for c, want in (([0.25, 0.25, 0.5], [0, 0, -1]),
                    ([0.25, 0.25, -0.5], [0, 0, 1])):
        c = np.array(c, np.float32)
        got = tg.face_outward_normal(*(torch.from_numpy(x)
                                       for x in (p0, p1, p2, c)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        assert _eq(jg.face_outward_normal(*(jnp.asarray(x)
                                            for x in (p0, p1, p2, c))), got)

    rng = np.random.RandomState(8)
    pts = rng.randn(4, 500, 3).astype(np.float32)
    want = np.asarray(jg.face_outward_normal(*(jnp.asarray(x) for x in pts)))
    got = tg.face_outward_normal(*(torch.from_numpy(x) for x in pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    pts[2] = pts[1]
    flat = tg.face_outward_normal(*(torch.from_numpy(x) for x in pts))
    assert not flat.any()


@pytest.mark.parametrize("kind", ["cameras", "random"])
def test_inverse44_matches_float64(kind):
    """``inverse44`` (the API's inverses) against the float64 inverse: 1
    ulp of each entry (entries that cancel to about 0 within 1e-12 of the
    matrix's largest), and against JAX's ``jnp.linalg.inv`` at the f32
    tolerance: the ring cameras' modelview and projection matrices, and
    random matrices."""
    if kind == "cameras":
        mv, proj = scenes.ring_cameras(8, radius=3.0)
        m = np.concatenate([np.swapaxes(mv, 1, 2), np.swapaxes(proj, 1, 2)])
    else:
        m = np.random.RandomState(11).randn(64, 4, 4)
    m = m.astype(np.float32)
    got = tg.inverse44(torch.from_numpy(m)).numpy()
    want = np.linalg.inv(m.astype(np.float64))
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - want) <= ulp + 1e-12 * scale).all()
    jax_inv = np.asarray(jnp.linalg.inv(jnp.asarray(m)))
    assert float((np.abs(got - jax_inv) / scale).max()) <= 1e-5
