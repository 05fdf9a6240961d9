"""The torch port's train step against the JAX package's, on CPU.

The same scene (carried by ``convert.tri_scene_from_numpy``), view batch
and target go through the JAX package's ``make_train_step`` with
``optax.adam(1e-2)`` and the port's with ``torch.optim.Adam(lr=1e-2)``,
both optimisers starting from zero state, on the dense and the binned path.

Tolerances: the first step's gradients within 1e-4 relative (the binned
path's tolerance of test_golden.py); the losses of 3 steps within 1e-5
relative; the parameters after them within ``PARAM_ATOL`` and, on the
entries whose gradient is clear of 0 at every step (|g| above 1e-3 of the
largest), within ``PARAM_TIGHT``. Adam divides each update by the root of
its running squared gradient, so an entry whose gradient is near 0
(|g| ~ eps) takes a step whose size follows the last bits of g: gradient
noise far below 1e-4 relative is amplified there. On this scene the
largest gap after 3 steps is 8.4e-7 over all entries and 4.2e-7 over the
clear ones (CPU, both paths), so ``PARAM_ATOL`` leaves a 10x margin for
the amplified entries and ``PARAM_TIGHT`` holds the clear ones to a few
f32 ulps of their O(1) values.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dmesh_renderer_tpu.models import dmesh as jdm
from dmesh_renderer_tpu_torch.convert import (
    tri_scene_from_numpy,
    view_batch_from_numpy,
)
from dmesh_renderer_tpu_torch.models import dmesh as tdm
import scenes

H, W, B, N_TRIS = 32, 32, 2, 20
LR = 1e-2
PARAM_ATOL = 1e-5
PARAM_TIGHT = 2e-6


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def problem():
    soup = scenes.random_triangle_soup(N_TRIS, seed=31)
    mv, proj = scenes.ring_cameras(B, radius=3.0)
    vd, fi = scenes.soup_view_attrs(soup, B, seed=32)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    target = np.random.RandomState(33).uniform(
        0, 1, (B, 3, H, W)).astype(np.float32)
    batch = (mv_t, proj_t, np.linalg.inv(mv_t), np.linalg.inv(proj_t), vd,
             fi, target)
    scene = (soup["verts"], soup["verts_color"], soup["faces_opacity"])
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    return scene, soup["faces"], batch, bg


def _jax_run(problem, force, n_steps):
    scene, faces, batch, bg = problem
    opt = optax.adam(LR)
    jscene = jdm.TriScene(*map(jnp.asarray, scene))
    jbatch = jdm.ViewBatch(*map(jnp.asarray, batch))
    loss_fn = jdm.make_loss_fn(jnp.asarray(faces), jnp.asarray(bg), H, W,
                               force=force)
    grads = jax.jit(jax.grad(loss_fn))(jscene, jbatch)
    step = jdm.make_train_step(opt, jnp.asarray(faces), jnp.asarray(bg), H,
                               W, force=force)
    state = jdm.init_train_state(jscene, opt)
    losses = []
    for _ in range(n_steps):
        state, loss = step(state, jbatch)
        losses.append(float(loss))
    return grads, losses, state.scene


def _port_state(problem):
    scene, _faces, batch, _bg = problem
    state = tdm.init_train_state(
        tri_scene_from_numpy(*scene, device="cpu"),
        lambda params: torch.optim.Adam(params, lr=LR))
    return state, view_batch_from_numpy(*batch, device="cpu")


@pytest.mark.parametrize("force", ["oracle", "binned"])
def test_train_steps_match_jax(problem, force):
    _scene, faces, _batch, bg = problem
    j_grads, j_losses, j_scene = _jax_run(problem, force, 3)

    state, batch = _port_state(problem)
    step = tdm.make_train_step(torch.from_numpy(faces), torch.from_numpy(bg),
                               H, W, force=force)
    losses, grads = [], []
    for _ in range(3):
        state, loss = step(state, batch)
        grads.append([p.grad.clone() for p in state.scene])
        losses.append(float(loss))
        assert loss.grad_fn is None

    for g, j in zip(grads[0], j_grads):
        assert _rel(g.numpy(), j) <= 1e-4
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    for k, (p, j) in enumerate(zip(state.scene, j_scene)):
        p, j = p.detach().numpy(), np.asarray(j)
        np.testing.assert_allclose(p, j, rtol=0, atol=PARAM_ATOL)
        # entries with a clear gradient at every step move as JAX's do
        clear = np.ones(p.shape, bool)
        for g in grads:
            g = g[k].numpy()
            clear &= np.abs(g) > 1e-3 * np.abs(g).max()
        assert clear.sum() > 0.3 * clear.size
        np.testing.assert_allclose(p[clear], j[clear], rtol=0,
                                   atol=PARAM_TIGHT)


def test_train_loop_matches_steps(problem):
    """``make_train_loop`` takes the same steps as repeated train steps."""
    _scene, faces, _batch, bg = problem
    f, b = torch.from_numpy(faces), torch.from_numpy(bg)
    state, batch = _port_state(problem)
    state, losses = tdm.make_train_loop(f, b, H, W, 3)(state, batch)
    state2, batch2 = _port_state(problem)
    step = tdm.make_train_step(f, b, H, W)
    want = [float(step(state2, batch2)[1]) for _ in range(3)]
    assert losses.shape == (3,)
    np.testing.assert_array_equal(losses.numpy(), np.float32(want))
    for p, q in zip(state.scene, state2.scene):
        assert torch.equal(p, q)


def test_mesh_raises(problem):
    """``mesh=`` takes the view mesh of ``parallel.make_view_mesh``
    (``tests/test_torch_sharding.py`` drives it); anything else raises."""
    _scene, faces, _batch, bg = problem
    f, b = torch.from_numpy(faces), torch.from_numpy(bg)
    with pytest.raises(TypeError, match="make_view_mesh"):
        tdm.make_train_step(f, b, H, W, mesh=object())
    with pytest.raises(TypeError, match="make_view_mesh"):
        tdm.make_train_loop(f, b, H, W, 2, mesh=object())
