"""The torch port's tet forward against the JAX package, on CPU: the
connectivity, validation, rays and jitter, the dense first hit, the march
tables, the whole forward on the spec and inside-camera scenes, the golden,
the NumPy spec and the API.

The JAX side runs once per scene through its public ``TetRenderer``, with
its stages wrapped so that their inputs and outputs are kept; the port's
stages are then fed the same bits. Tolerances: the active mask, first/last
face, last tet and n_contrib exactly; rays, t/u/v and the march tables'
geometry within 1e-6; colour and depth within ``FWD_ATOL`` (observed at
most 3.0e-6 on these scenes: the port rounds every f32 op as the JAX source
is written, XLA contracts some a*b+c into FMAs, and the two CPU exp/log
routines differ in the last bits).
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dmesh_renderer_tpu.ops.rays as jrays
import dmesh_renderer_tpu.ops.tet as jt
from dmesh_renderer_tpu.api import TetRenderSettings as JSettings
from dmesh_renderer_tpu.api import TetRenderer as JRenderer
from dmesh_renderer_tpu.utils import connectivity as jconn
from dmesh_renderer_tpu.validation import check_tet_inputs as j_check
from dmesh_renderer_tpu_torch import TetRenderSettings, TetRenderer, render_tet
from dmesh_renderer_tpu_torch.convert import tet_args_from_numpy
from dmesh_renderer_tpu_torch.ops import geometry as tg
from dmesh_renderer_tpu_torch.ops import rays as tr
from dmesh_renderer_tpu_torch.ops import tet as pt
from dmesh_renderer_tpu_torch.ops import tet_first_hit as pfh
from dmesh_renderer_tpu_torch.utils import connectivity as pconn
from dmesh_renderer_tpu_torch.validation import check_tet_inputs as p_check
from numpy_reference import render_tet_np
import scenes
import test_tet_spec
import test_torch_gpu_tet as gpu_tet

FWD_ATOL = 1e-5
STAGE_ATOL = 1e-6
SAVED_INT = ("first_face", "last_face", "last_tet", "n_contrib")


def spec_scene():
    """The scene of ``test_tet_spec``: 120 faces, B=2, 24x24 (dense)."""
    return test_tet_spec._scene(), 24, 24, 0


def inside_scene():
    """The inside-camera scene of ``test_tet_spec`` (ring radius 0.6)."""
    verts, tets = jconn.freudenthal_grid(2, jitter=0.12, seed=25)
    faces, face_tets, tet_faces = jconn.build_tet_connectivity(tets)
    rng = np.random.RandomState(26)
    vcolor = rng.rand(verts.shape[0], 3).astype(np.float32)
    fopacity = rng.uniform(0.25, 0.95, faces.shape[0]).astype(np.float32)
    fintense = rng.uniform(0.5, 1.0, (1, faces.shape[0])).astype(np.float32)
    mv, proj = scenes.ring_cameras(1, radius=0.6)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    bg = np.array([0.3, 0.1, 0.2], np.float32)
    return (verts, faces, vcolor, fopacity, mv_t, proj_t, fintense, tets,
            face_tets, tet_faces, bg), 24, 24, 0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain kernels run long loops of small torch ops, which gain
    nothing from intra-op threads and, beside the suite's parallel workers,
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def capturing(store, targets):
    """Wrap ``getattr(mod, name)`` for each (mod, name) so that every call's
    (args, output) is appended to ``store[name]``; restore on exit."""
    saved = []

    def wrap(fn, name):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            store.setdefault(name, []).append((a, out))
            return out
        return wrapper

    for mod, name in targets:
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, wrap(getattr(mod, name), name))
    try:
        yield store
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def user_inputs(sc):
    """The scene as a user passes it to ``TetRenderer`` (row-major
    matrices, zero vertex depths)."""
    (verts, faces, vcolor, fopacity, mv_t, proj_t, fintense, tets, face_tets,
     tet_faces, _bg) = sc
    return (verts, faces, vcolor, fopacity, np.swapaxes(mv_t, 1, 2),
            np.swapaxes(proj_t, 1, 2),
            np.zeros((mv_t.shape[0], verts.shape[0]), np.float32), fintense,
            tets, face_tets, tet_faces)


def run_jax(scene_fn, targets=()):
    """The JAX package's ``TetRenderer`` on the scene, with its forward and
    the given stages captured. Returns (scene, h, w, seed, outputs, store,
    the port's functional args with JAX's inverse matrices)."""
    sc, h, w, seed = scene_fn()
    store = {}
    with capturing(store, [(jt, "_render_tet_forward"), *targets]):
        out = JRenderer(JSettings(h, w, sc[10], ray_random_seed=seed))(
            *user_inputs(sc))
    fwd_args = store["_render_tet_forward"][0][0]
    inv_mv_t, inv_proj_t = (np.asarray(fwd_args[i]) for i in (6, 7))
    (verts, faces, vcolor, fopacity, mv_t, proj_t, fintense, tets, face_tets,
     tet_faces, bg) = sc
    targs = tet_args_from_numpy(verts, faces, vcolor, fopacity, mv_t, proj_t,
                                inv_mv_t, inv_proj_t, fintense, tets,
                                face_tets, tet_faces, bg, device="cpu")
    return sc, h, w, seed, [np.asarray(x) for x in out], store, targs


@pytest.fixture(scope="module")
def spec():
    return run_jax(spec_scene, [(jt, "generate_rays"),
                                (jt, "_first_intersection"),
                                (jt, "_march_tables")])


@pytest.fixture(scope="module")
def inside():
    return run_jax(inside_scene)


def t2n(x):
    return x.detach().cpu().numpy()


def assert_tuv_close(got, want):
    """t within STAGE_ATOL relative (t reaches ~3 here, where XLA's FMA
    contractions move it by a few ulps), u and v within STAGE_ATOL."""
    np.testing.assert_allclose(t2n(got[0]), np.asarray(want[0]),
                               rtol=STAGE_ATOL, atol=STAGE_ATOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(t2n(a), np.asarray(b), rtol=0,
                                   atol=STAGE_ATOL)


def assert_forward_matches(port, jax_fwd):
    color, depth, active, saved = port
    cj, dj, aj, sj = jax_fwd
    np.testing.assert_array_equal(t2n(active), np.asarray(aj))
    for k in SAVED_INT:
        np.testing.assert_array_equal(t2n(saved[k]), np.asarray(sj[k]), k)
    np.testing.assert_array_equal(t2n(saved["is_active"]),
                                  np.asarray(sj["is_active"]))
    np.testing.assert_allclose(t2n(color), np.asarray(cj), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(t2n(depth), np.asarray(dj), rtol=0,
                               atol=FWD_ATOL)
    for k in ("final_log_T", "final_prev_log_T"):
        np.testing.assert_allclose(t2n(saved[k]), np.asarray(sj[k]),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- inputs

@pytest.mark.parametrize("n,jitter,seed", [(2, 0.12, 7), (3, 0.1, 4)])
def test_connectivity_matches_jax(n, jitter, seed):
    vj, tj = jconn.freudenthal_grid(n, jitter=jitter, seed=seed)
    vp, tp = pconn.freudenthal_grid(n, jitter=jitter, seed=seed)
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_array_equal(tp, tj)
    for a, b in zip(pconn.build_tet_connectivity(tp),
                    jconn.build_tet_connectivity(tj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _bad_inputs():
    sc = spec_scene()[0]
    (verts, faces, vcolor, fopacity, mv_t, proj_t, fintense, tets, face_tets,
     tet_faces, bg) = sc
    base = [verts, faces, vcolor, fopacity, mv_t, proj_t, fintense, tets,
            face_tets, tet_faces, bg]
    cases = {"tets": (7, tets[:, :3]), "face_tets": (8, face_tets[:, :1]),
             "tet_faces": (9, tet_faces[:-1]), "verts": (0, verts[:, :2]),
             "fintense": (6, fintense[:1]), "bg": (10, bg[:2])}
    out = {}
    for k, (i, bad) in cases.items():
        args = list(base)
        args[i] = bad
        out[k] = args
    return out


@pytest.mark.parametrize("case", ["tets", "face_tets", "tet_faces", "verts",
                                  "fintense", "bg"])
def test_check_tet_inputs_messages(case):
    args = _bad_inputs()[case]
    with pytest.raises(ValueError) as ej:
        j_check(*args)
    with pytest.raises(ValueError) as ep:
        p_check(*args)
    assert str(ep.value) == str(ej.value)


def test_sqrt_rn_is_correctly_rounded():
    """``sqrt_rn`` gives NumPy's correctly rounded f32 root, the ray norms
    of the tet headline's range and beyond included."""
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.uniform(0.5, 20.0, 400_000), 10.0 ** rng.uniform(-30, 30, 100_000),
        [0.0, 1.0, 4.0, np.inf, 1e-45, 3.4e38]]).astype(np.float32)
    got = tg.sqrt_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.sqrt(x).view(np.uint32))


@pytest.mark.parametrize("seed", [1, 17])
@pytest.mark.parametrize("view_offset", [0, 3])
def test_jitter_uniforms_bit_equal(seed, view_offset):
    B, H, W = 2, 24, 24
    key = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(B, dtype=jnp.int32) + view_offset)

    def draw(k):
        kx, ky = jax.random.split(k)
        return (jax.random.uniform(kx, (H, W), dtype=jnp.float32),
                jax.random.uniform(ky, (H, W), dtype=jnp.float32))

    ux, uy = (np.asarray(x) for x in jax.vmap(draw)(keys))
    px, py = tr.jitter_uniforms(seed, B, H, W, view_offset)
    np.testing.assert_array_equal(t2n(px).view(np.uint32), ux.view(np.uint32))
    np.testing.assert_array_equal(t2n(py).view(np.uint32), uy.view(np.uint32))


@pytest.mark.parametrize("seed,view_offset", [(0, None), (17, None), (5, 3)])
def test_tet_rays_match_jax(seed, view_offset):
    sc = spec_scene()[0]
    inv_mv_t = np.linalg.inv(sc[4])
    inv_proj_t = np.linalg.inv(sc[5])
    H, W = 24, 20
    jit = dict(jitter_seed=seed if seed > 0 else None,
               view_offset=view_offset)
    ro_j, rd_j = jrays.generate_rays(jnp.asarray(inv_mv_t),
                                     jnp.asarray(inv_proj_t), W, H,
                                     norm_eps_mode="tet", **jit)
    ro_p, rd_p = tr.generate_rays(torch.from_numpy(inv_mv_t),
                                  torch.from_numpy(inv_proj_t), W, H,
                                  norm_eps_mode="tet", **jit)
    np.testing.assert_array_equal(t2n(ro_p), np.asarray(ro_j))
    np.testing.assert_allclose(t2n(rd_p), np.asarray(rd_j), rtol=0,
                               atol=STAGE_ATOL)


# ---------------------------------------------------------------- stages

def test_dense_first_hit_matches_jax(spec):
    _sc, h, w, _seed, _out, store, t = spec
    (verts, faces, valid, order, ray_o, ray_d), got = \
        store["_first_intersection"][0]
    ff, rt, iu, iv = pt.first_intersection_dense(
        t[0], t[1], torch.from_numpy(np.asarray(valid)),
        torch.from_numpy(np.asarray(order)).long(),
        torch.from_numpy(np.asarray(ray_o)),
        torch.from_numpy(np.asarray(ray_d)))
    np.testing.assert_array_equal(t2n(ff), np.asarray(got[0]))
    assert int((ff >= 0).sum()) > 0.5 * ff.numel()
    assert_tuv_close((rt, iu, iv), got[1:])


def test_dense_first_hit_order_matches_jax(spec):
    """The port's own preprocess and min-depth order feed the same valid
    mask and order as JAX's."""
    _sc, h, w, _seed, _out, store, t = spec
    (_v, _f, valid, order, _ro, _rd), _got = store["_first_intersection"][0]
    ndc, img = tg.project_verts(t[0], t[4], t[5], w, h)
    pre = tg.preprocess_faces(ndc, img, t[1], w, h, 16, 16)
    key = torch.where(pre["valid"], pre["min_depth"], float("inf"))
    np.testing.assert_array_equal(t2n(pre["valid"]), np.asarray(valid))
    np.testing.assert_array_equal(
        t2n(torch.sort(key, dim=1, stable=True).indices), np.asarray(order))


def test_march_tables_match_jax(spec):
    _sc, _h, _w, _seed, _out, store, t = spec
    want = store["_march_tables"][0][1]
    got = pt.march_tables(t[0], t[1], t[9], t[11], t[10], t[2], t[3], t[8])
    pack = np.asarray(want["tet_pack"])
    np.testing.assert_array_equal(t2n(got["tet_geo"])[:, :36], pack[:, :36])
    np.testing.assert_array_equal(t2n(got["tet_geo"])[:, 36:], pack[:, 36:40])
    np.testing.assert_array_equal(t2n(got["tet_ids"]),
                                  pack[:, 40:48].astype(np.int32))
    np.testing.assert_array_equal(t2n(got["sign"]), np.asarray(want["sign"]))
    np.testing.assert_allclose(t2n(got["geo"]), np.asarray(want["geo"]),
                               rtol=0, atol=STAGE_ATOL)
    shade, shade_j = t2n(got["shade"]), np.asarray(want["shade"])
    cols = [c for c in range(12) if c != 10]
    np.testing.assert_array_equal(shade[:, cols], shade_j[:, cols])
    np.testing.assert_allclose(shade[:, 10], shade_j[:, 10], rtol=1e-6)


def test_march_plain_on_cpu(spec):
    """``first_hit``/``fwd_march`` on CPU tensors run their plain versions
    (no launch), and reject bad arguments."""
    _sc, h, w, _seed, _out, _store, t = spec
    before = (pfh.first_hit.launches, pt.fwd_march.launches)
    pt.render_tet_forward(*t, h, w, 0)
    assert (pfh.first_hit.launches, pt.fwd_march.launches) == before
    z = torch.zeros((4, 3))
    i4 = torch.zeros(4, dtype=torch.int32)
    ids = torch.zeros((1, 8), dtype=torch.int32)
    head = (z, torch.zeros((1, 3)), torch.zeros((4, 4)))
    with pytest.raises(ValueError, match="4 rays for 1 views of 3x1"):
        pt.fwd_march(*head, i4, i4, torch.zeros((3, 4)), torch.zeros((1, 40)),
                     torch.zeros((1, 12)), ids, torch.zeros((2, 12)), 3, 1)
    with pytest.raises(TypeError):
        pt.fwd_march(*head, torch.zeros(4), i4, torch.zeros((3, 4)),
                     torch.zeros((1, 40)), torch.zeros((1, 12)), ids,
                     torch.zeros((2, 12)), 2, 2)
    # the normal table: [T, 12] f32 beside the geometry's T rows
    with pytest.raises(ValueError, match=r"expected shape \(1, 12\)"):
        pt.fwd_march(*head, i4, i4, torch.zeros((3, 4)), torch.zeros((1, 40)),
                     torch.zeros((2, 12)), ids, torch.zeros((1, 12)), 2, 2)
    with pytest.raises(TypeError):
        pt.fwd_march(*head, i4, i4, torch.zeros((3, 4)), torch.zeros((1, 40)),
                     torch.zeros((1, 12), dtype=torch.float64), ids,
                     torch.zeros((1, 12)), 2, 2)


@pytest.mark.parametrize("case", ["adversarial", "outside"])
def test_march_normal_table_bit_equal(case, monkeypatch):
    """The march that reads ``march_tables``' ``tet_nrm`` (K4's walk) gives
    the bits of the march that rebuilds every outward normal from the
    geometry, on the adversarial scene (a jittered grid, cameras at its
    edge) and with cameras outside the mesh."""
    args, h, w, seed = gpu_tet._scene(case)
    s = gpu_tet._stages(tet_args_from_numpy(*args, device="cpu"), h, w, seed)
    got = pt.fwd_march_plain(*s["march_inputs"])
    walk = pt._walk
    monkeypatch.setattr(pt, "_walk",
                        lambda *a, nrm=None, **kw: walk(*a, **kw))
    want = pt.fwd_march_plain(*s["march_inputs"])
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    n_contrib, active = want[1][2], want[1][3]
    assert int(active.sum()) > 0 and int(n_contrib.max()) > 2


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("name", ["spec", "inside"])
def test_forward_matches_jax(name, request):
    _sc, h, w, seed, _out, store, t = request.getfixturevalue(name)
    port = pt.render_tet_forward(*t, h, w, seed)
    assert_forward_matches(port, store["_render_tet_forward"][0][1])
    assert int(port[2].sum()) > 0


def test_forward_matches_golden(spec):
    golden = dict(np.load(test_tet_spec.GOLDEN))
    _sc, h, w, seed, _out, _store, t = spec
    color, depth, active, _saved = pt.render_tet_forward(*t, h, w, seed)
    np.testing.assert_array_equal(t2n(active), golden["active"])
    for k, got in (("color", color), ("depth", depth)):
        want = golden[k]
        err = np.abs(t2n(got) - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-5, f"{k}: rel Linf {err}"


def test_forward_matches_numpy_spec():
    sc = spec_scene()[0]
    h, w = 12, 12
    c_n, d_n, act_n, aux = render_tet_np(*sc, h, w)
    (verts, faces, vcolor, fopacity, mv_t, proj_t, fintense, tets, face_tets,
     tet_faces, bg) = sc
    t = tet_args_from_numpy(verts, faces, vcolor, fopacity, mv_t, proj_t,
                            np.linalg.inv(mv_t), np.linalg.inv(proj_t),
                            fintense, tets, face_tets, tet_faces, bg,
                            device="cpu")
    color, depth, active, saved = pt.render_tet_forward(*t, h, w, 0)
    np.testing.assert_array_equal(t2n(active), act_n)
    assert act_n.sum() > 0
    for k in ("first_face", "last_face", "last_tet"):
        np.testing.assert_array_equal(t2n(saved[k]).reshape(aux[k].shape),
                                      aux[k])
    np.testing.assert_allclose(t2n(color), c_n, atol=2e-5)
    np.testing.assert_allclose(t2n(depth), d_n, atol=2e-5)


def test_binned_first_hit_matches_dense(spec, monkeypatch):
    """The whole forward with the binned first hit (K3's plain version)
    forced against the dense path."""
    _sc, h, w, seed, _out, _store, t = spec
    monkeypatch.setattr(pt, "BINNED_FIRST_HIT_THRESHOLD", 10 ** 9)
    cd, dd, ad, sd = pt.render_tet_forward(*t, h, w, seed)
    monkeypatch.setattr(pt, "BINNED_FIRST_HIT_THRESHOLD", 1)
    cb, db, ab, sb = pt.render_tet_forward(*t, h, w, seed)
    assert int(sb["fh_num_rendered"]) > 0 and not bool(sb["fh_overflow"])
    assert int(sd["fh_num_rendered"]) == -1
    assert torch.equal(ad, ab)
    for k in SAVED_INT:
        assert torch.equal(sd[k], sb[k]), k
    np.testing.assert_allclose(t2n(cb), t2n(cd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t2n(db), t2n(dd), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- API

def test_tetrenderer_matches_jax(spec):
    """The module path: casts, transposes and ``ops.geometry.inverse44``
    (whose inverses may differ from JAX's ``jnp.linalg.inv`` in the last
    bit, hence tolerances on colour and depth, the mask exact)."""
    sc, h, w, seed, out, _store, _t = spec
    r = TetRenderer(TetRenderSettings(h, w, sc[10]), device="cpu")
    color, depth, active = r(*user_inputs(sc))
    np.testing.assert_array_equal(t2n(active), out[2])
    np.testing.assert_allclose(t2n(color), out[0], rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(t2n(depth), out[1], rtol=0, atol=FWD_ATOL)
    assert color.dtype == torch.float32 and active.dtype == torch.bool
    assert color.shape == (2, 3, h, w) and depth.shape == (2, 1, h, w)


@pytest.mark.parametrize("empty", ["verts", "faces", "tets"])
def test_empty_geometry_fill(empty):
    sc = spec_scene()[0]
    u = list(user_inputs(sc))
    if empty == "verts":
        u[0], u[2], u[6] = u[0][:0], u[2][:0], u[6][:, :0]
    elif empty == "faces":
        u[1], u[3], u[7], u[9] = u[1][:0], u[3][:0], u[7][:, :0], u[9][:0]
    else:
        u[8], u[10] = u[8][:0], u[10][:0]
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    r = TetRenderer(TetRenderSettings(8, 6, bg), device="cpu")
    color, depth, active, (ovf, n) = r(*u, return_aux=True)
    assert color.shape == (2, 3, 8, 6)
    assert torch.equal(color, torch.from_numpy(bg)[None, :, None, None]
                       .expand(2, 3, 8, 6))
    assert bool((depth == 1).all()) and not bool(active.any())
    assert (bool(ovf), int(n)) == (False, 0)


def test_requires_grad_gives_gradients():
    """Inputs that require grad no longer raise: ``TetRenderer`` and
    ``render_tet_core`` return gradients for ``verts_color`` and
    ``faces_opacity`` (their values: ``tests/test_torch_tet_bwd.py``)."""
    sc = spec_scene()[0]
    u = list(user_inputs(sc))
    for i in (2, 3):
        v = list(u)
        v[i] = torch.from_numpy(u[i]).requires_grad_(True)
        c, d, _a = TetRenderer(TetRenderSettings(8, 8, sc[10]),
                               device="cpu")(*v)
        (c.sum() + d.sum()).backward()
        assert v[i].grad.shape == v[i].shape and bool(v[i].grad.any())
    t = list(tet_args_from_numpy(*sc[:6], np.linalg.inv(sc[4]),
                                 np.linalg.inv(sc[5]), *sc[6:], device="cpu"))
    t[3] = t[3].requires_grad_(True)
    c, _d, _a = pt.render_tet_core(*t, 8, 8, 0)
    c.sum().backward()
    assert bool(torch.isfinite(t[3].grad).all() and t[3].grad.any())


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sc = spec_scene()[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TetRenderer(TetRenderSettings(8, 8, sc[10]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_tet(*user_inputs(sc), TetRenderSettings(8, 8, sc[10]))
