"""The tri frame at static capacities, on the CPU.

Every tensor of a binned tri frame is sized from B, F, H, W and the
capacities, never from the scene: two scenes of the same sizes and
different pair counts give ``BinnedKeys``, K2 records and slot ids of the
same shapes. The overflow stays data (the JAX package's flag and
``num_rendered`` at a capacity that drops pairs), an eager frame reads it
once and warns once, and under a capture nothing is read and the bbox path
runs at static shapes. ``make_train_loop`` takes the JAX package's
``lax.scan`` loop's steps (``test_torch_train.py``'s tolerances). The
card's side -- the captured step and frame, bitwise against eager ones,
and the host syncs -- is ``test_torch_gpu_graph.py``.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

import dmesh_renderer_tpu as jdr
import dmesh_renderer_tpu.ops.tri as jtri
from dmesh_renderer_tpu.models import dmesh as jdm
import dmesh_renderer_tpu_torch as tdr
import dmesh_renderer_tpu_torch.ops.tri as ttri
from dmesh_renderer_tpu_torch.models import dmesh as tdm
from dmesh_renderer_tpu_torch.ops import binning as tb
from dmesh_renderer_tpu_torch.ops import tri_binned as ttb
from dmesh_renderer_tpu_torch.utils import scenes as tscenes
from test_torch_train import (  # noqa: F401  (problem: a fixture)
    LR, PARAM_ATOL, H as TRAIN_H, W as TRAIN_W, _port_state, problem,
)

H, W = 48, 40
KCAP = 4096
CONTEXT = "render_tri_binned; raise TriRenderSettings.key_capacity"


def _args(seed, n=300, views=2):
    """tri_scene inputs as functional args (transposed matrices, their
    inverses), CPU tensors."""
    v, f, vc, fo, mv, proj, vd, fi = (torch.from_numpy(x) for x in
                                      tscenes.tri_scene(n, views, H, W, seed))
    mv_t = mv.transpose(1, 2).contiguous()
    proj_t = proj.transpose(1, 2).contiguous()
    return (v, f, vc, fo, mv_t, proj_t, torch.linalg.inv(mv_t),
            torch.linalg.inv(proj_t), vd, fi, torch.tensor([0.1, 0.2, 0.3]))


def test_shapes_do_not_follow_the_scene():
    """Two scenes of the same B, F, H, W with different pair counts: the
    keys, the K2 records and the slot ids have the same shapes, sized by
    the key capacity; only the live prefixes differ."""
    shapes, live = [], []
    for seed in (3, 4):
        args = _args(seed)
        _c, _d, keys, inputs, state = ttb._forward(*args, H, W, KCAP, None)
        gin = torch.ones((2, 5, H, W))
        rec, ids = ttb.bwd_composite(*inputs[:6], *state, gin, *inputs[6:])
        shapes.append([tuple(x.shape) for x in (*keys, rec, ids)])
        live.append((int(keys.total), int(ttb.walked_slots(
            keys.starts, keys.ends, state[2], 2, H, W)[1])))
        assert keys.slot_face.numel() == KCAP and rec.shape[0] == KCAP
    assert shapes[0] == shapes[1]
    assert live[0][0] != live[1][0] and live[0][1] != live[1][1]


def test_overflow_and_num_rendered_match_jax(monkeypatch):
    """At a key capacity that drops pairs, ``render_tri(return_aux=True)``
    gives the JAX package's flag and ``num_rendered``, and the image within
    the binned path's 1e-4 (test_golden.py)."""
    monkeypatch.setattr(ttri, "BINNED_THRESHOLD_CPU", 0)
    monkeypatch.setattr(jtri, "BINNED_THRESHOLD_CPU", 0)
    args = [x.numpy() for x in _args(5, n=120, views=1)]
    kcap = 64
    argv = (*args[:6], args[8], args[9])
    jc, jd, (jo, jn) = jdr.render_tri(
        *(jnp.asarray(a) for a in argv),
        jdr.TriRenderSettings(H, W, jnp.asarray(args[10]), kcap),
        return_aux=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tc, td, (to, tn) = tdr.render_tri(
            *(torch.from_numpy(a) for a in argv),
            tdr.TriRenderSettings(H, W, torch.from_numpy(args[10]), kcap),
            return_aux=True, device="cpu")
    assert bool(jo) and bool(to) and int(tn) == int(jn) > kcap
    for t, j in ((tc, jc), (td, jd)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() / max(1.0, np.abs(j).max()) \
            <= 1e-4


@pytest.mark.parametrize("grad", [False, True])
def test_eager_frame_warns_once(grad):
    """A serving frame and a training frame (forward and backward) that
    overflow each warn exactly once, in the JAX package's wording."""
    args = list(_args(6))
    if grad:
        for i in (0, 2, 3, 8, 9):
            args[i] = args[i].clone().requires_grad_(True)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        c, d, (ovf, n) = ttb.render_tri_binned(*args, H, W, 64, True)
        if grad:
            (c.sum() + d.sum()).backward()
    msgs = [str(w.message) for w in rec]
    assert bool(ovf) and len(msgs) == 1
    assert CONTEXT in msgs[0] and (
        f"overflow ({int(n)} (face, tile) pairs emitted > capacity 64)"
        in msgs[0])


def test_capture_reads_nothing_and_bbox_raises(monkeypatch):
    """With a capture pretended (``binning.is_capturing``), an overflowing
    frame reads and warns nothing and returns its flag as data; the bbox
    emission path (the tet first hit, and tri above ``_EXACT_KCAP_MAX``,
    lowered here to take it at a small capacity) runs at ``kcap`` slots and
    gives the eager frame's keys and image bit for bit."""
    args = _args(6)
    monkeypatch.setattr(tb, "_EXACT_KCAP_MAX", KCAP)
    eager = ttb._forward(*args, H, W, KCAP, None)
    monkeypatch.setattr(tb, "is_capturing", lambda device: True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _c, _d, (ovf, _n) = ttb.render_tri_binned(*args, H, W, 64, True)
        got = ttb._forward(*args, H, W, KCAP, None)
    assert bool(ovf)
    assert got[2].slot_face.numel() == KCAP and not bool(got[2].overflow)
    for a, b in zip((*eager[:2], *eager[2]), (*got[:2], *got[2])):
        assert torch.equal(a, b)
    pre = {"tiles": torch.ones((2, 3), dtype=torch.int32),
           "rect_min": torch.zeros((2, 3, 2), dtype=torch.int32),
           "rect_max": torch.ones((2, 3, 2), dtype=torch.int32),
           "depth": torch.rand(2, 3)}
    keys = tb.emit_and_sort(pre, 2, 2, KCAP)
    assert int(keys.total) == 6 and int(keys.ends[-1]) == 6
    assert keys.slot_face.numel() == KCAP


def test_train_loop_matches_jax_scan(problem):  # noqa: F811
    """The port's ``make_train_loop`` against the JAX package's (``jax.jit``
    of a ``lax.scan`` over the steps), 3 Adam steps on the binned path:
    losses within 1e-5 relative, parameters within ``PARAM_ATOL``."""
    scene, faces, batch, bg = problem
    opt = optax.adam(LR)
    loop = jdm.make_train_loop(opt, jnp.asarray(faces), jnp.asarray(bg),
                               TRAIN_H, TRAIN_W, 3, force="binned")
    jstate = jdm.init_train_state(jdm.TriScene(*map(jnp.asarray, scene)), opt)
    jstate, jlosses = loop(jstate, jdm.ViewBatch(*map(jnp.asarray, batch)))

    state, tbatch = _port_state(problem)
    tloop = tdm.make_train_loop(torch.from_numpy(faces), torch.from_numpy(bg),
                                TRAIN_H, TRAIN_W, 3, force="binned")
    state, losses = tloop(state, tbatch)
    assert losses.shape == (3,) and tloop.step.captures == 0  # the CPU
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    assert float(losses[-1]) < float(losses[0])
    for p, j in zip(state.scene, jstate.scene):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=PARAM_ATOL)
