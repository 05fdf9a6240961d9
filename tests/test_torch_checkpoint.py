"""Checkpoint/resume of the port's train state (``utils/checkpoint.py``).

The counterpart of ``tests/test_checkpoint.py`` (round trip, "shape" and
"leaves"), plus a dtype mismatch, the resume path (Adam, 2 steps, save,
restore into a fresh ``init_train_state``, 2 more steps: bitwise equal to 4
uninterrupted steps, tri and tet) and a save under a 2-rank view mesh (rank
0 writes; both ranks restore the same bits).
"""

import os

import numpy as np
import pytest
import torch

from dmesh_renderer_tpu_torch import parallel
from dmesh_renderer_tpu_torch.models import dmesh as tdm
from dmesh_renderer_tpu_torch.models.dmesh import TriScene, init_train_state
from dmesh_renderer_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from dmesh_renderer_tpu_torch.utils.scenes import tet_scene, tri_scene

H = W = 24


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these small steps gain nothing from more, and
    beside the suite's parallel workers more only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adam(params):
    return torch.optim.Adam(params, lr=1e-2)


def _make_state(n_verts: int, seed: int = 0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    scene = TriScene(*(torch.from_numpy(x.astype(dtype)).requires_grad_(True)
                       for x in (rng.rand(n_verts, 3), rng.rand(n_verts, 3),
                                 rng.rand(3))))
    return init_train_state(scene, _adam)


def _opt_tensors(opt):
    sd = opt.state_dict()
    return [v for pid in sorted(sd["state"]) for _k, v in
            sorted(sd["state"][pid].items())]


def test_train_state_roundtrip(tmp_path):
    state = _make_state(9)
    loss = sum((p ** 2).sum() for p in state.scene)
    loss.backward()
    state.opt_state.step()  # the optimiser now holds moments
    path = save_checkpoint(str(tmp_path / "ckpt"), state)
    assert path == os.path.abspath(str(tmp_path / "ckpt"))
    restored = restore_checkpoint(path, _make_state(9, seed=5))
    assert type(restored) is type(state)
    assert type(restored.scene) is TriScene
    for a, b in zip(state.scene, restored.scene):
        assert torch.equal(a, b) and b.requires_grad and b.is_leaf
    got, want = (_opt_tensors(s.opt_state) for s in (restored, state))
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        assert torch.equal(a, b) and a.dtype == b.dtype
    # the restored optimiser steps the restored tensors
    assert [p for g in restored.opt_state.param_groups
            for p in g["params"]] == list(restored.scene)


def test_restore_rejects_mismatched_shapes(tmp_path):
    """A checkpoint saved from a differently sized scene fails loudly."""
    path = save_checkpoint(str(tmp_path / "ckpt"), _make_state(9))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, _make_state(12))


def test_restore_rejects_mismatched_leaf_count(tmp_path):
    state = _make_state(9)
    path = save_checkpoint(str(tmp_path / "ckpt"), state)
    # a template of another structure: the scene without its optimiser
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(path, state.scene)


def test_restore_rejects_mismatched_dtype(tmp_path):
    path = save_checkpoint(str(tmp_path / "ckpt"), _make_state(9))
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(path, _make_state(9, dtype=np.float64))


def test_save_refuses_to_overwrite_without_force(tmp_path):
    path = save_checkpoint(str(tmp_path / "ckpt"), _make_state(9))
    with pytest.raises(FileExistsError, match="force=True"):
        save_checkpoint(path, _make_state(9), force=False)
    save_checkpoint(path, _make_state(9, seed=1))
    state = restore_checkpoint(path, _make_state(9))
    assert torch.equal(state.scene.verts, _make_state(9, seed=1).scene.verts)


def _tri_run():
    verts, faces, vc, fo, mv, proj, vd, fi = tri_scene(40, 2, H, W, seed=4)
    mv_t = torch.from_numpy(np.swapaxes(mv, 1, 2).copy())
    proj_t = torch.from_numpy(np.swapaxes(proj, 1, 2).copy())
    target = torch.from_numpy(np.random.RandomState(5).uniform(
        0, 1, (2, 3, H, W)).astype(np.float32))
    batch = tdm.ViewBatch(mv_t, proj_t, torch.linalg.inv(mv_t),
                          torch.linalg.inv(proj_t), torch.from_numpy(vd),
                          torch.from_numpy(fi), target)
    step = tdm.make_train_step(torch.from_numpy(faces), torch.zeros(3), H, W)

    def fresh():
        return init_train_state(TriScene(*(
            torch.tensor(x, requires_grad=True) for x in (verts, vc, fo))),
            _adam)

    return fresh, step, batch


def _tet_run():
    (verts, faces, vc, fo, mv, proj, _vd, fi, tets, face_tets, tet_faces,
     bg) = tet_scene(3, 2, H, W)
    mv_t = torch.from_numpy(np.swapaxes(mv, 1, 2).copy())
    proj_t = torch.from_numpy(np.swapaxes(proj, 1, 2).copy())
    target = torch.from_numpy(np.random.RandomState(6).uniform(
        0, 1, (2, 3, H, W)).astype(np.float32))
    batch = tdm.TetViewBatch(mv_t, proj_t, torch.linalg.inv(mv_t),
                             torch.linalg.inv(proj_t), torch.from_numpy(fi),
                             target)
    geom = tdm.TetGeometry(*(torch.from_numpy(x) for x in (
        verts, faces, tets, face_tets, tet_faces)))
    step = tdm.make_tet_train_step(geom, torch.from_numpy(bg), H, W, seed=2)

    def fresh():
        return tdm.init_tet_train_state(tdm.TetScene(
            torch.tensor(vc, requires_grad=True),
            torch.tensor(fo, requires_grad=True)), _adam)

    return fresh, step, batch


@pytest.mark.parametrize("run", [_tri_run, _tet_run], ids=["tri", "tet"])
def test_resume_is_bitwise(tmp_path, run):
    """Adam, 2 steps, save, restore into a fresh state, 2 more steps: the
    same bits as 4 uninterrupted steps (parameters, losses, moments)."""
    fresh, step, batch = run()
    state, want = fresh(), []
    for _ in range(4):
        state, loss = step(state, batch)
        want.append(float(loss))
    part, got = fresh(), []
    for _ in range(2):
        part, loss = step(part, batch)
        got.append(float(loss))
    path = save_checkpoint(str(tmp_path / "mid.pt"), part)
    resumed = restore_checkpoint(path, fresh())
    for _ in range(2):
        resumed, loss = step(resumed, batch)
        got.append(float(loss))
    assert got == want
    for a, b in zip(resumed.scene, state.scene):
        assert torch.equal(a, b)
    for a, b in zip(_opt_tensors(resumed.opt_state),
                    _opt_tensors(state.opt_state)):
        assert torch.equal(a, b) and a.device == b.device


def _ranks_save_restore(path):
    """One rank: a sharded Adam step, a save under the mesh, a restore into
    a fresh state; returns the bits before and after."""
    mesh = parallel.make_view_mesh(device="cpu")
    fresh, _step, batch = _tri_run()
    faces = torch.from_numpy(tri_scene(40, 2, H, W, seed=4)[1])
    step = tdm.make_train_step(faces, torch.zeros(3), H, W, mesh=mesh)
    st = fresh()
    st = init_train_state(parallel.replicate_params(mesh, st.scene), _adam)
    st, _loss = step(st, parallel.shard_view_batch(mesh, batch))
    wrote = save_checkpoint(path, st, mesh=mesh)
    restored = restore_checkpoint(wrote, fresh())
    return {"exists": os.path.exists(wrote),
            "saved": [p.detach().clone() for p in st.scene],
            "restored": [p.detach().clone() for p in restored.scene],
            "moments": _opt_tensors(restored.opt_state)}


def test_save_under_two_ranks(tmp_path):
    """Rank 0 writes, every rank waits for it and restores the same bits."""
    path = str(tmp_path / "mesh.pt")
    outs = parallel.spawn(_ranks_save_restore, 2, (path,), timeout=120.0)
    assert os.listdir(tmp_path) == ["mesh.pt"]
    for r in outs:
        assert r["exists"]
        for a, b in zip(r["saved"], r["restored"]):
            assert torch.equal(a, b)
        assert len(r["moments"]) == 9
    for a, b in zip(outs[0]["restored"] + outs[0]["moments"],
                    outs[1]["restored"] + outs[1]["moments"]):
        assert torch.equal(a, b)
