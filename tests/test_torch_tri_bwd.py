"""The torch port's tri backward against the JAX package, its goldens and
the NumPy spec, on CPU.

Tolerances (rel Linf: max |got - want| / max(1, max |want|)):

- gradient helpers: the clamp Jacobian exactly; the Moller-Trumbore
  gradients within ``MT_GRAD_RTOL`` of JAX and of ``numpy_reference``;
- plain K2 + record reduce against JAX's binned VJP (its backward Pallas
  kernel in interpret mode): 1e-4, the tolerance of the binned path in
  test_golden.py -- the sums over pixels and slots run in another order;
- oracle and binned gradients against ``golden/tri_scene.npz``: 1e-5 and
  1e-4 (test_golden.py);
- the oracle backward against ``numpy_reference.render_tri_np_backward``:
  2e-4 (test_tri_oracle.py);
- the adversarial scene against JAX with the projection rounded op by op:
  GRAD_RTOL 2e-4 (test_golden_adversarial.py); against the golden file
  itself see ``test_adversarial_grads``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dmesh_renderer_tpu.ops.tri_binned as jtb
from dmesh_renderer_tpu.ops import geometry as jg
import dmesh_renderer_tpu_torch.ops.tri as ttri
from dmesh_renderer_tpu_torch.convert import tri_inputs_from_numpy
from dmesh_renderer_tpu_torch.ops import geometry as tg
from dmesh_renderer_tpu_torch.ops import reduce as trd
from dmesh_renderer_tpu_torch.ops import tri_binned as ttb
from dmesh_renderer_tpu_torch.ops.tri import render_tri_auto
from dmesh_renderer_tpu_torch.ops.tri_oracle import render_tri_oracle
import numpy_reference as ref
import scenes
import test_golden
import test_golden_adversarial as tga
from test_torch_geometry import jax_geometry, scene

KCAP = 8192
NAMES = ("verts", "verts_color", "faces_opacity", "verts_depth",
         "faces_intense")
DIFF = (0, 2, 3, 8, 9)  # argument positions of the five differentiable inputs
# The Moller-Trumbore vertex gradients are quotients by denom^2, which
# amplify last-bit differences: XLA contracts the jitted jnp.cross into
# FMAs and NumPy's dot sums in another order than the port's separate f32
# ops. Observed on CPU at |denom| > 0.1: at most 2.2e-6 (rel Linf).
MT_GRAD_RTOL = 4e-6
# Adversarial golden: the rel Linf error of the gradients against
# tri_adversarial.npz, as observed on CPU (rounded up in the 4th digit).
# The golden was rendered under jit, whose FMA-contracted projection flips
# the coverage of 3 pixels (test_torch_tri_fwd.MAX_FLIP_PIXELS), and those
# pixels carry large gradients. The JAX package with its projection
# rounded op by op is off from the golden by the same amounts, and the
# port matches that within GRAD_RTOL.
ADV_GOLDEN_PINNED = {"g_verts": 0.1097, "g_vcolor": 0.01854,
                     "g_fopacity": 0.02605, "g_vdepth": 0.02488,
                     "g_fintense": 0.005186}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _weights(shape_c, shape_d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape_c).astype(np.float32),
            rng.randn(*shape_d).astype(np.float32))


def _port_grads(t, h, w, loss, force):
    """The five gradients of ``loss(color, depth)`` through the port's
    dispatch (``force``: "oracle" or "binned")."""
    t = list(t)
    for i in DIFF:
        t[i] = t[i].clone().requires_grad_(True)
    c, d = render_tri_auto(*t, h, w, force=force, kcap=KCAP)
    loss(c, d).backward()
    return [t[i].grad for i in DIFF]


def _jax_binned_grads(name, wc, wd, monkeypatch):
    """JAX's binned VJP (interpret-mode backward kernel) of
    sum(color * wc) + sum(depth * wd), its projection taken eagerly."""
    a, _t, h, w = scene(name)
    ndc, img, _pre = jax_geometry(name)
    monkeypatch.setattr(jtb, "project_verts", lambda *_a, **_k: (ndc, img))
    x = list(map(jnp.asarray, a))

    @jax.jit
    def grads(v, vc, fo, vd, fi):
        def f(v, vc, fo, vd, fi):
            c, d = jtb.render_tri_binned(v, x[1], vc, fo, *x[4:8], vd, fi,
                                         x[10], h, w, KCAP)
            return jnp.sum(c * wc) + jnp.sum(d * wd)
        return jax.grad(f, argnums=tuple(range(5)))(v, vc, fo, vd, fi)

    return grads(*(x[i] for i in DIFF))


def test_clamp_grad_matches_jax_and_numpy():
    u, v = np.meshgrid(np.linspace(-1.5, 2.5, 41, dtype=np.float32),
                       np.linspace(-1.5, 2.5, 41, dtype=np.float32))
    _uc, _vc, code = tg.clamp_bary_uv(torch.from_numpy(u),
                                      torch.from_numpy(v))
    assert set(code.unique().tolist()) == set(range(7))
    got = tg.clamp_bary_uv_grad(code)
    want = jg.clamp_bary_uv_grad(jnp.asarray(code.numpy()))
    for g, j in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    spec = np.array([ref.np_clamp_grad(int(c)) for c in code.reshape(-1)])
    np.testing.assert_array_equal(
        np.stack([g.reshape(-1).numpy() for g in got], -1), spec)


def test_mt_grads_match_jax_and_numpy():
    rng = np.random.RandomState(3)
    n = 2000
    o = rng.randn(n, 3).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = rng.randn(3, n, 3).astype(np.float32)
    got = tg.ray_tri_uv_grads_reference(*(torch.from_numpy(x) for x in
                                          (o, d, *p)))
    want = jg.ray_tri_uv_grads_reference(*(jnp.asarray(x) for x in
                                           (o, d, *p)))
    # the formula is a quotient by denom^2: keep rays that are not close to
    # the triangle's plane, where one rounding moves a value by its size
    denom = np.einsum("ij,ij->i", np.cross(d, p[2] - p[0]), p[1] - p[0])
    ok = np.abs(denom) > 0.1
    assert ok.sum() > n // 2
    spec = [np.stack(ref.np_mt_grads(o[i], d[i], p[0, i], p[1, i], p[2, i]))
            for i in np.nonzero(ok)[0]]
    spec = np.stack(spec, 1)  # [6, n_ok, 3]
    for k, (g, j) in enumerate(zip(got, want)):
        g = g.numpy()[ok]
        assert _rel(g, np.asarray(j)[ok]) <= MT_GRAD_RTOL, k
        assert _rel(g, spec[k]) <= MT_GRAD_RTOL, k


@pytest.mark.parametrize("name", ["binned_fixture", "golden"])
def test_plain_backward_matches_jax_vjp(name, monkeypatch):
    """bwd_composite_plain + reduce_records against jax.vjp of the JAX
    package's render_tri_binned, the same random upstream gradients."""
    a, t, h, w = scene(name)
    B = a[4].shape[0]
    wc, wd = _weights((B, 3, h, w), (B, 1, h, w), seed=21)
    want = _jax_binned_grads(name, wc, wd, monkeypatch)

    _c, _d, keys, inputs, state = ttb._forward(*t, h, w, KCAP, None)
    gin = ttb.upstream_planes(torch.from_numpy(wc), torch.from_numpy(wd),
                              t[10])
    rec = ttb.bwd_composite_plain(*inputs[:6], *state, gin, *inputs[6:])
    assert rec.shape == (keys.slot_face.numel(), 4, ttb.REC_COLS)
    assert int((rec != 0).any(-1).sum()) > 0
    got = ttb.reduce_records(rec, keys.slot_face, keys.sigma, inputs[3],
                             t[1], t[9], t[0].shape[0])
    for n, g, j in zip(NAMES, got, want):
        assert tuple(g.shape) == tuple(np.shape(j)), n
        assert _rel(g.numpy(), j) < 1e-4, (n, _rel(g.numpy(), j))


def test_bwd_composite_on_cpu_runs_plain():
    _a, t, h, w = scene("binned_fixture")
    _c, _d, _keys, inputs, state = ttb._forward(*t, h, w, KCAP, None)
    B = inputs[6]
    gin = torch.ones((B, 5, h, w))
    before = ttb.bwd_composite.launches
    got = ttb.bwd_composite(*inputs[:6], *state, gin, *inputs[6:])
    assert ttb.bwd_composite.launches == before  # no kernel on the CPU
    assert torch.equal(got, ttb.bwd_composite_plain(*inputs[:6], *state,
                                                    gin, *inputs[6:]))
    with pytest.raises(TypeError):
        ttb.bwd_composite(*inputs[:6], *state, gin.double(), *inputs[6:])
    with pytest.raises(ValueError):
        ttb.bwd_composite(*inputs[:6], *state, gin[:, :4], *inputs[6:])


@pytest.mark.parametrize("force,tol", [("oracle", 1e-5), ("binned", 1e-4)])
def test_grads_match_golden(force, tol):
    """The loss of test_golden.py: two renders, the verts gradient through
    the second one only."""
    golden = dict(np.load(test_golden.GOLDEN))
    _a, t, h, w = scene("golden")
    t = list(t)
    leaves = [t[i].clone().requires_grad_(True) for i in DIFF]
    v, vc, fo, vd, fi = leaves
    c, d = render_tri_auto(t[0], t[1], vc, fo, *t[4:8], vd, fi, t[10], h, w,
                           force=force)
    c2, d2 = render_tri_auto(v, *t[1:10], t[10], h, w, force=force)
    ((c * c).sum() + d.sum() + (c2 * d2).sum()).backward()
    keys = ("g_verts", "g_vcolor", "g_fop", "g_vdepth", "g_fint")
    for k, leaf in zip(keys, leaves):
        assert _rel(leaf.grad.numpy(), golden[k]) < tol, k


def test_oracle_backward_matches_numpy_spec():
    """The scene and upstream gradients of test_tri_oracle.py."""
    H = W = 24
    soup = scenes.random_triangle_soup(12, seed=7)
    mv, proj = scenes.ring_cameras(2, radius=3.0)
    vdepth, fintense = scenes.soup_view_attrs(soup, 2, seed=8)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    args = (soup["verts"], soup["faces"], soup["verts_color"],
            soup["faces_opacity"])
    _c, _d, aux = ref.render_tri_np(*args, mv_t, proj_t, vdepth, fintense,
                                    bg, H, W)
    rng = np.random.RandomState(11)
    gc = rng.randn(2, 3, H, W).astype(np.float32)
    gd = rng.randn(2, 1, H, W).astype(np.float32)
    want = ref.render_tri_np_backward(*args, mv_t, proj_t, vdepth, fintense,
                                      bg, H, W, gc, gd, aux)
    t = tri_inputs_from_numpy(*args, mv_t, proj_t, np.linalg.inv(mv_t),
                              np.linalg.inv(proj_t), vdepth, fintense, bg,
                              device="cpu")
    got = _port_grads(t, H, W, lambda c, d: (c * torch.from_numpy(gc)).sum()
                      + (d * torch.from_numpy(gd)).sum(), "oracle")
    for n, g in zip(NAMES, got):
        assert _rel(g.numpy(), want[n]) < 2e-4, n


@pytest.fixture
def adversarial(monkeypatch):
    """The adversarial scene, the loss weights of
    test_golden_adversarial.py and JAX's binned gradients of that loss."""
    _a, t, h, w = scene("adversarial")
    wc = np.cos(np.arange(3 * h * w, dtype=np.float32)).reshape(1, 3, h, w)
    wd = np.sin(np.arange(h * w, dtype=np.float32)).reshape(1, 1, h, w)
    want = _jax_binned_grads("adversarial", wc, wd, monkeypatch)
    return t, h, w, wc, wd, [np.asarray(j) for j in want]


def test_adversarial_grads(adversarial):
    """The adversarial golden scene: the port's binned gradients against
    JAX's (projection rounded op by op) within GRAD_RTOL, and against the
    golden file within the pinned error of its coverage flips."""
    t, h, w, wc, wd, want = adversarial
    got = _port_grads(t, h, w, lambda c, d: (c * torch.from_numpy(wc)).sum()
                      + (d * torch.from_numpy(wd)).sum(), "binned")
    golden = dict(np.load(tga.GOLDEN))
    for n, g, j in zip(NAMES, got, want):
        assert _rel(g.numpy(), j) <= tga.GRAD_RTOL, (n, _rel(g.numpy(), j))
    for k, g in zip(ADV_GOLDEN_PINNED, got):
        err = _rel(g.numpy(), golden[k])
        assert err <= ADV_GOLDEN_PINNED[k], (k, err)


@pytest.mark.parametrize("force", ["oracle", "binned"])
def test_grads_bitwise_deterministic(force):
    """The scene of tests/test_determinism.py, twice."""
    H = W = 24
    soup = scenes.random_triangle_soup(10, seed=5)
    mv, proj = scenes.ring_cameras(2)
    vdepth, fintense = scenes.soup_view_attrs(soup, 2)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    t = tri_inputs_from_numpy(
        soup["verts"], soup["faces"], soup["verts_color"],
        soup["faces_opacity"], mv_t, proj_t, np.linalg.inv(mv_t),
        np.linalg.inv(proj_t), vdepth, fintense, [0.1, 0.2, 0.3],
        device="cpu")

    def loss(c, d):
        return (c * c).sum() + d.sum()

    g1 = _port_grads(t, H, W, loss, force)
    g2 = _port_grads(t, H, W, loss, force)
    assert any(bool(g.any()) for g in g1)
    for x, y in zip(g1, g2):
        assert torch.equal(x, y)


def test_seg_sum_plain_matches_float64():
    rng = np.random.RandomState(9)
    n, n_seg, C = 3000, 257, 5
    ids = rng.randint(0, n_seg - 7, size=n)  # the last segments stay empty
    vals = rng.randn(n, C).astype(np.float32)
    want = np.zeros((n_seg, C))
    np.add.at(want, ids, vals.astype(np.float64))
    csr = trd.segment_csr(torch.from_numpy(ids), n_seg)
    got = trd.seg_sum(torch.from_numpy(vals), csr)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert not got[-7:].any()
    # inner > 1 orders rows as a stable sort of the expanded ids does
    csr4 = trd.segment_csr(torch.from_numpy(ids), n_seg, inner=4)
    csr1 = trd.segment_csr(torch.from_numpy(np.repeat(ids, 4)), n_seg)
    assert torch.equal(csr4.order, csr1.order)
    assert torch.equal(csr4.offsets, csr1.offsets)
    with pytest.raises(TypeError):
        trd.seg_sum(torch.from_numpy(vals).double(), csr)


def test_segment_csr_int32_and_edges():
    """``segment_csr`` gives int32 row ids (the kernel's input) and int64
    offsets; seg_sum takes no other id type; no rows give zero sums, no
    segments an empty result, and one long segment adds in row order."""
    ids = torch.tensor([2, 0, 2, 1, 0])
    csr = trd.segment_csr(ids, 4, inner=2)
    assert csr.order.dtype == torch.int32 and csr.offsets.dtype == torch.int64
    assert csr.order.tolist() == [2, 3, 8, 9, 6, 7, 0, 1, 4, 5]
    assert csr.offsets.tolist() == [0, 4, 6, 10, 10]
    vals = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    with pytest.raises(TypeError):
        trd.seg_sum(vals, trd.SegmentCSR(csr.order.long(), csr.offsets))
    none = trd.segment_csr(torch.zeros(0, dtype=torch.int64), 3)
    assert torch.equal(trd.seg_sum(torch.zeros(0, 2), none), torch.zeros(3, 2))
    empty = trd.segment_csr(torch.zeros(0, dtype=torch.int64), 0)
    assert trd.seg_sum(torch.zeros(0, 5), empty).shape == (0, 5)
    x = torch.tensor([[1e8], [1.0], [-1e8], [1.0]])
    one = trd.segment_csr(torch.zeros(4, dtype=torch.int64), 1)
    # ((1e8 + 1) - 1e8) + 1 in f32: the 1 is lost to rounding, then added
    assert trd.seg_sum(x, one).item() == 1.0


def test_empty_geometry_zero_grads():
    """P == 0: a constant zero image; F == 0: background through the
    oracle. Both give zero gradients of the inputs' shapes."""
    _a, t, h, w = scene("binned_fixture")
    B = t[4].shape[0]
    for sel in ("P==0", "F==0"):
        t2 = list(t)
        if sel == "P==0":
            t2[0], t2[2], t2[8] = t[0][:0], t[2][:0], t[8][:, :0]
        t2[1], t2[3], t2[9] = t[1][:0], t[3][:0], t[9][:, :0]
        for i in DIFF:
            t2[i] = t2[i].clone().requires_grad_(True)
        c, d = render_tri_auto(*t2, h, w)
        assert c.shape == (B, 3, h, w)
        ((c * c).sum() + d.sum()).backward()
        for i in DIFF:
            assert t2[i].grad.shape == t2[i].shape
            assert not t2[i].grad.any(), (sel, i)


def test_forward_without_grad_saves_nothing(monkeypatch):
    """Without requires_grad the forward builds no autograd graph; with it
    the binned path records its Function."""
    _a, t, h, w = scene("binned_fixture")
    monkeypatch.setattr(ttri, "BINNED_THRESHOLD_CPU", 0)
    c, d = render_tri_auto(*t, h, w)
    assert c.grad_fn is None and d.grad_fn is None
    t2 = list(t)
    t2[3] = t[3].clone().requires_grad_(True)
    c2, _d2 = render_tri_auto(*t2, h, w)
    assert type(c2.grad_fn).__name__.startswith("_RenderTriBinned")
    assert torch.equal(c, c2.detach())
