"""The torch port's tet backward against the JAX package, on CPU: the walk
in both directions, the gradients of ``verts_color`` and ``faces_opacity``
against both tet goldens, the NumPy spec and both of JAX's backward
algorithms, the re-walk mismatch count, determinism, the zero gradients of
the other inputs and of empty geometry, and the module path against the JAX
package's torch bridge.

Each scene's port gradients and JAX's are computed once per module, with
the same upstream gradients (``test_tet_spec``'s, from a seeded NumPy
generator) and the same inverse matrices (JAX's ``jnp.linalg.inv``).
Gradients are compared as rel Linf, ``max |got - want| / max(1, |want|)``.

Tolerances and what was observed (CPU):

- ``GRAD_RTOL`` 1e-5 (the JAX package's own bound against its golden,
  ``test_tet_spec.py:207``), as (``verts_color``, ``faces_opacity``):
  against ``tet_scene.npz`` 1.6e-6, 1.2e-6; JAX's replay backward 7.7e-7,
  3.3e-7; its marching backward 3.3e-6, 2.8e-6 (the two JAX backwards
  are 2.9e-6, 2.6e-6 apart); JAX's torch bridge 1.7e-6, 1.2e-6.
- ``ADV_RTOL`` 2e-5 on the adversarial scene (``tet_adversarial.npz``, made
  by JAX's marching backward: its walks of 25 steps exceed the march log).
  ``verts_color`` is 2.0e-6 from it, ``faces_opacity`` 1.03e-5: face 2802 is
  the first face of all 2304 pixels of view 0, just in front of the camera,
  where the projective depth is sensitive to the last bits of t. Its 2304
  records sum to -461.141 with |records| summing to 16,362; held against a
  float64 re-walk of the same float32 inputs, the port's records are 7.0e-5
  from it and the golden 4.0e-3 (``tests/tet_bwd_precision.py``), so the
  gap is the reference's rounding (XLA contracts a*b+c into FMAs inside the
  interpret-mode kernel) amplified by that cancellation.
- ``SPEC_RTOL`` 2e-4 against the NumPy spec (``test_tet_spec.py:93``):
  1.3e-6, 1.5e-6 on the spec scene, 1.1e-7, 6.2e-7 inside the mesh.
- The walk's t/u/v equal JAX's ``_connectivity_step`` exactly (op by op,
  each f32 op rounded once on both sides).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dmesh_renderer_tpu.ops.tet as jt
from dmesh_renderer_tpu.api import TetRenderSettings as JSettings
from dmesh_renderer_tpu.api import TetRenderer as JRenderer
from dmesh_renderer_tpu_torch import TetRenderSettings, TetRenderer
from dmesh_renderer_tpu_torch.convert import tet_args_from_numpy
from dmesh_renderer_tpu_torch.ops import tet as pt
from numpy_reference import render_tet_np, render_tet_np_backward
import test_golden_tet_adversarial as tga
import test_tet_spec
from test_torch_tet_fwd import (  # noqa: F401 (one_torch_thread: autouse)
    inside_scene, one_torch_thread, t2n, user_inputs,
)

GRAD_RTOL = 1e-5
ADV_RTOL = 2e-5
SPEC_RTOL = 2e-4
NP_HW = 12  # image size of the NumPy spec runs (its loops are per pixel)


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def upstream(B, h, w, seed=5):
    """``test_tet_spec``'s upstream gradients: dL/dcolor, dL/ddepth."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 3, h, w).astype(np.float32),
            rng.randn(B, 1, h, w).astype(np.float32))


def port_args(sc):
    """The port's functional args with JAX's inverse matrices."""
    (verts, faces, vc, fo, mv_t, proj_t, fi, tets, ft, tf, bg) = sc
    inv = [np.asarray(jnp.linalg.inv(jnp.asarray(m))) for m in (mv_t, proj_t)]
    return list(tet_args_from_numpy(verts, faces, vc, fo, mv_t, proj_t, *inv,
                                    fi, tets, ft, tf, bg, device="cpu"))


def port_grads(t, h, w, seed, wc, wd):
    """(g_vcolor, g_fopacity, the re-walk's mismatch count) of the port."""
    t = list(t)
    t[2] = t[2].detach().clone().requires_grad_(True)
    t[3] = t[3].detach().clone().requires_grad_(True)
    c, d, _a = pt.render_tet_core(*t, h, w, seed)
    ((c * torch.from_numpy(wc)).sum()
     + (d * torch.from_numpy(wd)).sum()).backward()
    return t2n(t[2].grad), t2n(t[3].grad), int(pt.bwd_march.mismatches)


def jax_grads(sc, h, w, seed, wc, wd):
    """JAX's gradients through its ``render_tet_core`` (op by op)."""
    scj = list(map(jnp.asarray, sc))

    def loss(vc, fo):
        c, d, _act = jt.render_tet_core(
            scj[0], scj[1], vc, fo, scj[4], scj[5], jnp.linalg.inv(scj[4]),
            jnp.linalg.inv(scj[5]), scj[6], scj[7], scj[8], scj[9], scj[10],
            h, w, seed)
        return jnp.sum(c * jnp.asarray(wc)) + jnp.sum(d * jnp.asarray(wd))

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1))(scj[2], scj[3])]


@pytest.fixture(scope="module")
def spec():
    sc = test_tet_spec._scene()
    h, w = test_tet_spec.H, test_tet_spec.W
    wc, wd = upstream(test_tet_spec.B, h, w)
    t = port_args(sc)
    replay = jax_grads(sc, h, w, 0, wc, wd)
    with pytest.MonkeyPatch.context() as mp:
        # a march log shorter than the scene's walks: the marching backward
        mp.setattr(jt, "LOG_CAP", 2)
        marching = jax_grads(sc, h, w, 0, wc, wd)
    return dict(sc=sc, h=h, w=w, seed=0, wc=wc, wd=wd, t=t,
                port=port_grads(t, h, w, 0, wc, wd), replay=replay,
                marching=marching)


@pytest.fixture(scope="module")
def adversarial():
    sc = tga._scene()
    h, w = tga.H, tga.W
    wc, wd = upstream(tga.B, h, w)
    t = port_args(sc)
    return dict(sc=sc, h=h, w=w, seed=tga.SEED, wc=wc, wd=wd, t=t,
                port=port_grads(t, h, w, tga.SEED, wc, wd))


def numpy_case(name):
    sc = test_tet_spec._scene() if name == "spec" else inside_scene()[0]
    wc, wd = upstream(sc[4].shape[0], NP_HW, NP_HW, seed=6)
    _c, _d, _act, aux = render_tet_np(*sc, NP_HW, NP_HW)
    want = render_tet_np_backward(*sc, NP_HW, NP_HW, wc, wd, aux)
    got = port_grads(port_args(sc), NP_HW, NP_HW, 0, wc, wd)
    return got, (want["verts_color"], want["faces_opacity"])


# ---------------------------------------------------------------- the walk

@pytest.mark.parametrize("direction", [1, -1])
def test_walk_matches_jax_connectivity_step(spec, direction):
    """``_walk`` against JAX's ``_connectivity_step`` on every (tet, face
    slot) of the spec scene, each ray through the face's centroid and the
    tet's: entering the tet through the face for the forward walk, leaving
    it through the face for the backward one."""
    t = spec["t"]
    m = pt.march_tables(t[0], t[1], t[9], t[11], t[10], t[2], t[3], t[8])
    T = m["tet_geo"].shape[0]
    tet = torch.arange(T).repeat_interleave(4)
    slot = torch.arange(4).repeat(T)
    cf = m["tet_ids"][tet, slot]
    centroid = t[0][t[1][cf.long()].long()].mean(dim=1)
    corners = t[0][t[9][tet].long()]
    inner = corners.mean(dim=1)
    o = inner + (centroid - inner) * 3.0 * direction
    d = centroid - o
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    g, ids = m["tet_geo"][tet], m["tet_ids"][tet]
    err, nf, nt, tt, uu, vv = pt._walk(g, ids, cf, o.unbind(1), d.unbind(1),
                                       direction)
    pack = np.concatenate([t2n(g), t2n(ids).astype(np.float32)], axis=1)
    jout = jt._connectivity_step(
        lambda c: jnp.asarray(pack[:, c]), jnp.asarray(t2n(cf), jnp.float32),
        *[jnp.asarray(t2n(x)) for x in (*o.unbind(1), *d.unbind(1))],
        direction)
    np.testing.assert_array_equal(t2n(err), np.asarray(jout[0]))
    assert 0 < int((~err).sum()) < err.numel()
    ok = t2n(~err)
    for got, want in ((nf, jout[1]), (nt, jout[2])):
        np.testing.assert_array_equal(t2n(got)[ok],
                                      np.asarray(want)[ok].astype(np.int32))
    # JAX runs op by op here, each f32 op rounded once, as the port's
    for got, want in ((tt, jout[3]), (uu, jout[4]), (vv, jout[5])):
        np.testing.assert_array_equal(t2n(got)[ok], np.asarray(want)[ok])


@pytest.mark.parametrize("direction", [1, -1])
def test_walk_normal_table_bit_equal(spec, direction):
    """``march_tables``' ``tet_nrm`` (sign * n-hat per slot, which K5's walk
    reads) gives the walk the bits of the normals it rebuilds from the
    geometry, on every (tet, face slot) of the spec scene with rays through
    the face's centroid and with random rays."""
    t = spec["t"]
    m = pt.march_tables(t[0], t[1], t[9], t[11], t[10], t[2], t[3], t[8])
    T = m["tet_geo"].shape[0]
    tet = torch.arange(T).repeat_interleave(4)
    slot = torch.arange(4).repeat(T)
    cf = m["tet_ids"][tet, slot]
    centroid = t[0][t[1][cf.long()].long()].mean(dim=1)
    inner = t[0][t[9][tet].long()].mean(dim=1)
    rng = np.random.RandomState(12)
    o_rand = torch.from_numpy(rng.randn(4 * T, 3).astype(np.float32))
    d_rand = torch.from_numpy(rng.randn(4 * T, 3).astype(np.float32))
    o = torch.cat([inner + (centroid - inner) * 3.0 * direction, o_rand])
    d = torch.cat([centroid - o[:4 * T], d_rand])
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    tet, cf = tet.repeat(2), cf.repeat(2)
    g, ids, nrm = m["tet_geo"][tet], m["tet_ids"][tet], m["tet_nrm"][tet]
    want = pt._walk(g, ids, cf, o.unbind(1), d.unbind(1), direction)
    got = pt._walk(g, ids, cf, o.unbind(1), d.unbind(1), direction, nrm=nrm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert 0 < int((~want[0]).sum()) < want[0].numel()


def test_walk_back_returns_to_the_previous_face(spec):
    """A forward step and a backward step from the face it reached, inside
    the same tet, lead back to the first face with its t/u/v."""
    _c, _d, _a, saved = pt.render_tet_forward(*spec["t"], spec["h"],
                                              spec["w"], 0)
    m = saved["march"]
    M = saved["ray_d"].shape[0]
    N = spec["h"] * spec["w"]
    ff = saved["first_face"].reshape(M)
    # rays of two or more blends that entered a tet at their first face:
    # one forward step from the first face, then one backward step
    first_tet = pt.start_tets(ff, saved["ray_d"], m["geo"], m["sign"],
                              spec["t"][10], spec["t"][11])
    sel = torch.nonzero((saved["n_contrib"].reshape(M) >= 2)
                        & (first_tet >= 0)).squeeze(1)
    assert sel.numel() > 50
    o = [saved["cam_o"][sel // N, k] for k in range(3)]
    d = [saved["ray_d"][sel, k] for k in range(3)]
    ct = first_tet[sel].long()
    err, nf, _nt, *_tuv = pt._walk(m["tet_geo"][ct], m["tet_ids"][ct],
                                   ff[sel], o, d, 1)
    assert not bool(err.any())
    err_b, back, back_tet, *_ = pt._walk(m["tet_geo"][ct], m["tet_ids"][ct],
                                         nf, o, d, -1)
    assert not bool(err_b.any())
    assert torch.equal(back, ff[sel])
    np.testing.assert_array_equal(t2n(back_tet), t2n(
        torch.where(spec["t"][10][ff[sel].long(), 0] == first_tet[sel],
                    spec["t"][10][ff[sel].long(), 1],
                    spec["t"][10][ff[sel].long(), 0])))


# ---------------------------------------------------------------- gradients

def test_grads_match_golden_spec(spec):
    golden = dict(np.load(test_tet_spec.GOLDEN))
    g_vc, g_fo, _bad = spec["port"]
    assert rel(g_vc, golden["g_vcolor"]) <= GRAD_RTOL
    assert rel(g_fo, golden["g_fopacity"]) <= GRAD_RTOL


def test_grads_match_golden_adversarial(adversarial):
    golden = dict(np.load(tga.GOLDEN))
    g_vc, g_fo, _bad = adversarial["port"]
    assert rel(g_vc, golden["g_vcolor"]) <= ADV_RTOL
    assert rel(g_fo, golden["g_fopacity"]) <= ADV_RTOL
    assert np.abs(g_fo).max() > 100.0  # the deep, near-plane walks ran


@pytest.mark.parametrize("path", ["replay", "marching"])
def test_grads_match_jax(spec, path):
    """The port against both of JAX's backward algorithms: the log replay
    (its default) and the marching backward, whose step is the Pallas
    kernel K5 replaces."""
    g_vc, g_fo, _bad = spec["port"]
    want = spec[path]
    assert rel(g_vc, want[0]) <= GRAD_RTOL
    assert rel(g_fo, want[1]) <= GRAD_RTOL
    assert np.abs(want[1]).max() > 1.0


@pytest.mark.parametrize("name", ["spec", "inside"])
def test_grads_match_numpy_spec(name):
    got, want = numpy_case(name)
    assert rel(got[0], want[0]) < SPEC_RTOL
    assert rel(got[1], want[1]) < SPEC_RTOL
    assert got[2] == 0
    assert np.abs(want[1]).max() > 0.1


@pytest.mark.parametrize("name", ["spec", "adversarial", "inside"])
def test_rewalk_retraces_the_forward(name, request):
    """The re-walk meets the first face at exactly each ray's last record,
    on every ray of every scene."""
    if name == "inside":
        sc, h, w, seed = inside_scene()
        wc, wd = upstream(1, h, w)
        bad = port_grads(port_args(sc), h, w, seed, wc, wd)[2]
    else:
        bad = request.getfixturevalue(name)["port"][2]
    assert bad == 0


def test_bwd_march_records(spec):
    """K5's plain version writes one record per blend of an active ray, in
    its slots, with the face as key, and fills nothing else: the buffers
    have the static record capacity's rows, and the rows past the records
    keep the key F and zeros."""
    s = spec
    _c, _d, _a, saved = pt.render_tet_forward(*s["t"], s["h"], s["w"], 0)
    ray_i, ray_f, off, n, total, overflow = pt.bwd_start_state(
        saved, s["t"][10], torch.from_numpy(s["wc"]), torch.from_numpy(s["wd"]),
        s["t"][12])
    m = saved["march"]
    before = pt.bwd_march.launches
    keys, rec, bad = pt.bwd_march(saved["ray_d"], saved["cam_o"],
                                  saved["zw"], ray_i, ray_f, off, n,
                                  m["tet_geo"], m["tet_nrm"], m["tet_ids"],
                                  m["shade"], s["h"] * s["w"])
    assert pt.bwd_march.launches == before  # the plain version on the CPU
    act = saved["is_active"].reshape(-1)
    nc = saved["n_contrib"].reshape(-1)
    B = s["t"][4].shape[0]
    assert n == pt.record_capacity(B, s["h"], s["w"], 512)
    assert int(total) == int(nc[act].sum()) < n and not bool(overflow)
    assert keys.shape == (n,)
    assert rec.shape == (n, pt.REC_COLS) and not bool(bad.any())
    F = s["t"][1].shape[0]
    live = int(total)
    assert int(keys[:live].min()) >= 0 and int(keys[:live].max()) < F
    assert bool((keys[live:] == F).all()) and not bool(rec[live:].any())
    # each active ray's records run from its last face to its first
    r = torch.nonzero(act & (nc >= 2)).squeeze(1)
    assert torch.equal(keys[off[r]], saved["last_face"].reshape(-1)[r])
    last = off[r] + nc[r].long() - 1
    assert torch.equal(keys[last], saved["first_face"].reshape(-1)[r])
    with pytest.raises(TypeError):
        pt.bwd_march(saved["ray_d"], saved["cam_o"], saved["zw"],
                     ray_i.long(), ray_f, off, n, m["tet_geo"],
                     m["tet_nrm"], m["tet_ids"], m["shade"], s["h"] * s["w"])
    with pytest.raises(ValueError):
        pt.bwd_march(saved["ray_d"], saved["cam_o"], saved["zw"], ray_i,
                     ray_f[:10], off, n, m["tet_geo"], m["tet_nrm"],
                     m["tet_ids"], m["shade"], s["h"] * s["w"])


def test_grads_bitwise_deterministic(adversarial):
    a = adversarial
    again = port_grads(a["t"], a["h"], a["w"], a["seed"], a["wc"], a["wd"])
    for x, y in zip(a["port"][:2], again[:2]):
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))


def test_other_inputs_get_zero_grads(spec):
    """As the reference: verts, the four matrices, faces_intense and bg get
    zero gradients, the integer inputs none."""
    t = [x.detach().clone() for x in spec["t"]]
    diff = (0, 2, 3, 4, 5, 6, 7, 8, 12)
    for i in diff:
        t[i].requires_grad_(True)
    c, d, _a = pt.render_tet_core(*t, spec["h"], spec["w"], 0)
    (c.sum() + d.sum()).backward()
    for i in diff:
        g = t[i].grad
        assert g is not None and g.shape == t[i].shape
        assert bool(g.any()) == (i in (2, 3)), i


def test_no_graph_without_grad(spec):
    before = pt.bwd_march.launches, pt.bwd_march.mismatches
    c, d, a = pt.render_tet_core(*spec["t"], spec["h"], spec["w"], 0)
    assert c.grad_fn is None and d.grad_fn is None and not a.requires_grad
    assert (pt.bwd_march.launches, pt.bwd_march.mismatches) == before


@pytest.mark.parametrize("empty", ["verts", "faces", "tets"])
def test_empty_geometry_grads(empty):
    """No geometry: ``bg`` gets the fill's gradient (dL/dcolor summed over
    the image), every other float input zeros, and backward() does not
    raise."""
    u = list(user_inputs(test_tet_spec._scene()))
    if empty == "verts":
        u[0], u[2], u[6] = u[0][:0], u[2][:0], u[6][:, :0]
    elif empty == "faces":
        u[1], u[3], u[7], u[9] = u[1][:0], u[3][:0], u[7][:, :0], u[9][:0]
    else:
        u[8], u[10] = u[8][:0], u[10][:0]
    leaves = {i: torch.from_numpy(np.array(u[i])).requires_grad_(True)
              for i in (0, 2, 3, 4, 5, 7)}
    u = [leaves.get(i, x) for i, x in enumerate(u)]
    bg = torch.tensor([0.2, 0.4, 0.6], requires_grad=True)
    wc, _wd = upstream(2, 8, 6)
    c, d, _a = TetRenderer(TetRenderSettings(8, 6, bg), device="cpu")(*u)
    ((c * torch.from_numpy(wc)).sum() + d.sum()).backward()
    for x in leaves.values():
        assert x.grad is not None and x.grad.shape == x.shape
        assert not bool(x.grad.any())
    np.testing.assert_allclose(t2n(bg.grad), wc.sum(axis=(0, 2, 3)),
                               rtol=1e-5)


def test_tetrenderer_grads_match_jax_torch_bridge(spec):
    """The module path (casts, transposes, ``ops.geometry.inverse44``)
    against the JAX package's ``TetRenderer`` on torch tensors, whose
    gradients come through its autograd bridge."""
    sc, h, w = spec["sc"], spec["h"], spec["w"]
    wc, wd = (torch.from_numpy(x) for x in (spec["wc"], spec["wd"]))
    grads = []
    for renderer in (JRenderer(JSettings(h, w, torch.from_numpy(sc[10]))),
                     TetRenderer(TetRenderSettings(h, w, sc[10]),
                                 device="cpu")):
        u = [torch.from_numpy(np.array(x)) for x in user_inputs(sc)]
        u[2].requires_grad_(True)
        u[3].requires_grad_(True)
        c, d, _a = renderer(*u)
        ((torch.as_tensor(c) * wc).sum()
         + (torch.as_tensor(d) * wd).sum()).backward()
        grads.append((t2n(u[2].grad), t2n(u[3].grad)))
    (jvc, jfo), (pvc, pfo) = grads
    assert rel(pvc, jvc) <= GRAD_RTOL
    assert rel(pfo, jfo) <= GRAD_RTOL
