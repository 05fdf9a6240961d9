"""The torch port's tet train step against the JAX package's, on CPU.

The same tet scene (carried by ``convert.tet_scene_from_numpy``), geometry,
view batch and target go through the JAX package's ``make_tet_train_step``
with ``optax.adam(1e-2)`` and the port's with ``torch.optim.Adam(lr=1e-2)``,
both optimisers starting from zero state.

Tolerances, those that ``test_torch_train.py`` settled for the tri step:
the first step's gradients within 1e-4 relative, the losses of 3 steps
within 1e-5 relative, the parameters after them within ``PARAM_ATOL`` on
all entries and ``PARAM_TIGHT`` on the entries whose gradient is clear of 0
at every step (see there for why Adam amplifies the others). Observed on
the CPU: gradients 1.9e-9, losses 1.2e-6, parameters 3.0e-7 (all entries
and the clear ones).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dmesh_renderer_tpu.models import dmesh as jdm
from dmesh_renderer_tpu_torch.convert import (
    tet_scene_from_numpy,
    tet_view_batch_from_numpy,
)
from dmesh_renderer_tpu_torch.models import dmesh as tdm
import test_tet_spec
from test_torch_tet_fwd import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import PARAM_ATOL, PARAM_TIGHT, _rel

H, W = 16, 16
LR = 1e-2


@pytest.fixture(scope="module")
def problem():
    (verts, faces, vc, fo, mv_t, proj_t, fi, tets, face_tets, tet_faces,
     _bg) = test_tet_spec._scene()
    inv = [np.asarray(jnp.linalg.inv(jnp.asarray(m))) for m in (mv_t, proj_t)]
    target = np.random.RandomState(34).uniform(
        0, 1, (mv_t.shape[0], 3, H, W)).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    return dict(scene=(vc, fo), geom=(verts, faces, tets, face_tets,
                                      tet_faces),
                batch=(mv_t, proj_t, *inv, fi, target), bg=bg)


def _port_geom(p):
    verts, faces, tets, face_tets, tet_faces = p["geom"]
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    return tdm.TetGeometry(torch.from_numpy(verts), i32(faces), i32(tets),
                           i32(face_tets), i32(tet_faces))


def _port_state(p):
    state = tdm.init_tet_train_state(
        tet_scene_from_numpy(*p["scene"], device="cpu"),
        lambda params: torch.optim.Adam(params, lr=LR))
    return state, tet_view_batch_from_numpy(*p["batch"], device="cpu")


def _jax_run(p, n_steps):
    opt = optax.adam(LR)
    scene = jdm.TetScene(*map(jnp.asarray, p["scene"]))
    geom = jdm.TetGeometry(*map(jnp.asarray, p["geom"]))
    batch = jdm.TetViewBatch(*map(jnp.asarray, p["batch"]))
    bg = jnp.asarray(p["bg"])
    se_fn = jdm.make_tet_se_fn(geom, bg, H, W)

    def loss(scene):
        se, cnt = se_fn(scene, batch)
        return se / jnp.maximum(cnt, 1.0)

    grads = jax.grad(loss)(scene)
    step = jdm.make_tet_train_step(opt, geom, bg, H, W)
    state = jdm.init_tet_train_state(scene, opt)
    losses = []
    for _ in range(n_steps):
        state, l_ = step(state, batch)
        losses.append(float(l_))
    return grads, losses, state.scene


def test_tet_train_steps_match_jax(problem):
    j_grads, j_losses, j_scene = _jax_run(problem, 3)
    state, batch = _port_state(problem)
    step = tdm.make_tet_train_step(_port_geom(problem),
                                   torch.from_numpy(problem["bg"]), H, W)
    losses, grads = [], []
    for _ in range(3):
        state, loss = step(state, batch)
        grads.append([p.grad.clone() for p in state.scene])
        losses.append(float(loss))
        assert loss.grad_fn is None

    for g, j in zip(grads[0], j_grads):
        assert _rel(g.numpy(), j) <= 1e-4
        assert bool(g.any())
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    for k, (p, j) in enumerate(zip(state.scene, j_scene)):
        p, j = p.detach().numpy(), np.asarray(j)
        np.testing.assert_allclose(p, j, rtol=0, atol=PARAM_ATOL)
        clear = np.ones(p.shape, bool)
        for g in grads:
            g = g[k].numpy()
            clear &= np.abs(g) > 1e-3 * np.abs(g).max()
        assert clear.sum() > 0.2 * clear.size
        np.testing.assert_allclose(p[clear], j[clear], rtol=0,
                                   atol=PARAM_TIGHT)


def test_tet_train_loop_matches_steps(problem):
    geom, bg = _port_geom(problem), torch.from_numpy(problem["bg"])
    state, batch = _port_state(problem)
    state, losses = tdm.make_tet_train_loop(geom, bg, H, W, 3)(state, batch)
    state2, batch2 = _port_state(problem)
    step = tdm.make_tet_train_step(geom, bg, H, W)
    want = [float(step(state2, batch2)[1]) for _ in range(3)]
    assert losses.shape == (3,)
    np.testing.assert_array_equal(losses.numpy(), np.float32(want))
    for p, q in zip(state.scene, state2.scene):
        assert torch.equal(p, q)


def test_tet_mesh_raises(problem):
    """``mesh=`` takes the view mesh of ``parallel.make_view_mesh``
    (``tests/test_torch_sharding.py`` drives it); anything else raises."""
    geom, bg = _port_geom(problem), torch.from_numpy(problem["bg"])
    with pytest.raises(TypeError, match="make_view_mesh"):
        tdm.make_tet_train_step(geom, bg, H, W, mesh=object())
    with pytest.raises(TypeError, match="make_view_mesh"):
        tdm.make_tet_train_loop(geom, bg, H, W, 2, mesh=object())


def test_se_fn_view_offset_matches_jax(problem):
    """``make_tet_se_fn``'s ``se_fn(scene, batch, view_offset)`` with
    jittered rays (seed 7) at ``view_offset=3``: the squared error, the
    count and both gradients as JAX's; the offset moves the jitter."""
    p = problem
    seed = 7
    scene = jdm.TetScene(*map(jnp.asarray, p["scene"]))
    geom = jdm.TetGeometry(*map(jnp.asarray, p["geom"]))
    batch = jdm.TetViewBatch(*map(jnp.asarray, p["batch"]))
    j_se = jdm.make_tet_se_fn(geom, jnp.asarray(p["bg"]), H, W, seed)
    j_err, j_cnt = j_se(scene, batch, view_offset=3)
    j_g = jax.grad(lambda s: j_se(s, batch, view_offset=3)[0])(scene)
    t_se = tdm.make_tet_se_fn(_port_geom(p), torch.from_numpy(p["bg"]), H,
                              W, seed)
    state, t_batch = _port_state(p)
    t_err, t_cnt = t_se(state.scene, t_batch, view_offset=3)
    t_err.backward()
    assert _rel(t_err.detach().numpy(), np.asarray(j_err)) <= 1e-5
    assert float(t_cnt) == float(j_cnt) > 0
    for tg, jg in zip((state.scene.verts_color.grad,
                       state.scene.faces_opacity.grad), j_g):
        assert _rel(tg.numpy(), np.asarray(jg)) <= 1e-4
    with torch.no_grad():
        t0 = t_se(state.scene, t_batch)[0]
    assert float(t0) != float(t_err.detach())
