"""Multi-view training over ``torch.distributed``, on the CPU.

The counterpart of ``tests/test_sharding.py``, case by case: the port's
train steps on a 2-rank gloo view mesh (``parallel.spawn``, the ranks on the
CPU) against the port's one-process step on the same batch, at
``test_sharding.py``'s tolerances (tri loss rtol 1e-6, tet loss rtol 2e-5;
parameters rtol 2e-5, atol 1e-7), and against the JAX package's sharded
step on its 2-device view mesh (the conftest's CPU devices) at the
tolerances ``test_torch_train.py`` settled (gradients 1e-4 rel, losses
1e-5 rel). Both ranks' parameters are bitwise equal after every step.

Each spawn runs every check of its renderer at once and the tests read its
results (module-scoped fixtures), so the file starts two pairs of ranks.
The rank workers are module-level functions, which the ranks import by
name: this module imports JAX only inside its JAX-reference helpers.
"""

import hashlib
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dmesh_renderer_tpu_torch import parallel
from dmesh_renderer_tpu_torch.convert import (
    tet_scene_from_numpy,
    tet_view_batch_from_numpy,
    tri_scene_from_numpy,
    view_batch_from_numpy,
)
from dmesh_renderer_tpu_torch.models import dmesh as tdm
from dmesh_renderer_tpu_torch.ops.tri import render_tri_auto
from dmesh_renderer_tpu_torch.utils.connectivity import (
    build_tet_connectivity,
    freudenthal_grid,
)
import scenes

H = W = 16
B = 8
RANKS = 2
SPAWN_TIMEOUT = 120.0  # seconds; each spawn below takes ~10 s on the CPU
LR = 1e-2


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def digest(tensors):
    """The bits of ``tensors``, hashed: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------- problems

def tri_problem():
    """``test_sharding.py``'s setup: 16 triangles, 8 ring views, 16x16."""
    soup = scenes.random_triangle_soup(16, seed=2)
    mv, proj = scenes.ring_cameras(B)
    vdepth, fintense = scenes.soup_view_attrs(soup, B)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    batch = (mv_t, proj_t, np.linalg.inv(mv_t), np.linalg.inv(proj_t),
             vdepth, fintense, np.full((B, 3, H, W), 0.5, np.float32))
    scene = (soup["verts"], soup["verts_color"], soup["faces_opacity"])
    return scene, soup["faces"], batch


def tet_problem(uneven=False):
    """``test_sharding.py``'s tet setup: ``freudenthal_grid(2, 0.05, 9)``,
    8 ring views, 16x16. ``uneven``: the second half of the views (rank
    1's) from twice as far, so that the ranks' active counts differ."""
    verts, tets = freudenthal_grid(2, jitter=0.05, seed=9)
    faces, face_tets, tet_faces = build_tet_connectivity(tets)
    rng = np.random.RandomState(1)
    scene = (rng.rand(verts.shape[0], 3).astype(np.float32),
             rng.uniform(0.3, 0.9, faces.shape[0]).astype(np.float32))
    mv, proj = scenes.ring_cameras(B, radius=3.0)
    if uneven:
        mv[B // 2:] = scenes.ring_cameras(B, radius=6.0)[0][B // 2:]
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    batch = (mv_t, proj_t, np.linalg.inv(mv_t), np.linalg.inv(proj_t),
             rng.uniform(0.5, 1.0, (B, faces.shape[0])).astype(np.float32),
             np.full((B, 3, H, W), 0.4, np.float32))
    geom = (verts, faces, tets, face_tets, tet_faces)
    return scene, geom, batch


def _tet_geom(geom):
    verts, *ints = geom
    return tdm.TetGeometry(torch.from_numpy(verts),
                           *(torch.from_numpy(np.asarray(a, np.int32))
                             for a in ints))


def _sgd(params):
    return torch.optim.SGD(params, lr=LR)


def _adam(params):
    return torch.optim.Adam(params, lr=5e-2)


def _tri_state(scene, opt, mesh=None):
    s = tri_scene_from_numpy(*scene, device="cpu")
    if mesh is not None:
        s = parallel.replicate_params(mesh, s)
    return tdm.init_train_state(s, opt)


def _tet_state(scene, opt, mesh=None):
    s = tet_scene_from_numpy(*scene, device="cpu")
    if mesh is not None:
        s = parallel.replicate_params(mesh, s)
    return tdm.init_tet_train_state(s, opt)


def _steps(step, state, batch, n):
    """``n`` steps: the losses and each step's parameter digest."""
    losses, digests = [], []
    for _ in range(n):
        state, loss = step(state, batch)
        losses.append(float(loss))
        digests.append(digest(state.scene))
    return state, losses, digests


def _sgd_result(state, loss):
    held = loss.untyped_storage()
    return {"loss": float(loss),
            "scene": [p.detach().clone() for p in state.scene],
            "grads": [p.grad.clone() for p in state.scene],
            "loss_bytes": held.nbytes(),
            "loss_holds_grads": any(
                held.data_ptr() == p.grad.untyped_storage().data_ptr()
                for p in state.scene)}


# ------------------------------------------------------------ rank workers

def tri_rank():
    """Every tri check on one rank of the 2-rank mesh."""
    mesh = parallel.make_view_mesh(device="cpu")
    scene, faces, batch_np = tri_problem()
    f, bg = torch.from_numpy(faces), torch.zeros(3)
    batch = parallel.shard_view_batch(
        mesh, view_batch_from_numpy(*batch_np, device="cpu"))
    out = {"rank": mesh.rank, "size": mesh.size,
           "local_views": int(batch.mv_t.shape[0])}
    for force in (None, "binned"):
        step = tdm.make_train_step(f, bg, H, W, mesh=mesh, force=force)
        out[f"sgd_{force}"] = _sgd_result(
            *step(_tri_state(scene, _sgd, mesh), batch))
    step = tdm.make_train_step(f, bg, H, W, mesh=mesh)
    _, out["adam_losses"], out["adam_digests"] = _steps(
        step, _tri_state(scene, _adam, mesh), batch, 11)
    loop = tdm.make_train_loop(f, bg, H, W, 5, mesh=mesh)
    st, losses = loop(_tri_state(scene, _adam, mesh), batch)
    out["loop_losses"] = losses.tolist()
    out["loop_digest"] = digest(st.scene)

    # a gloo mesh on the CPU is never captured
    out["captured"] = [parallel.graph_capturable(mesh),
                       step._captured(st, batch), loop.step._captured(
                           st, batch)]

    # view_params pass through the sharded step unchanged
    st = _tri_state(scene, _sgd, mesh)
    vp = (batch.verts_depth, batch.faces_intense)
    vp_bits = digest(vp)
    st2, loss = step(tdm.TrainState(st.scene, vp, st.opt_state), batch)
    out["view_params"] = {"loss": float(loss), "same": st2.view_params is vp,
                          "bits_kept": digest(st2.view_params) == vp_bits}

    # a per-rank key-capacity overflow, seen on every rank after a MAX
    s = tri_scene_from_numpy(*scene, device="cpu")

    def render(kcap):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _c, _d, (ovf, total) = render_tri_auto(
                s.verts, f, s.verts_color, s.faces_opacity, batch.mv_t,
                batch.proj_t, batch.inv_mv_t, batch.inv_proj_t,
                batch.verts_depth, batch.faces_intense, bg, H, W,
                force="binned", kcap=kcap, with_aux=True)
        local = (int(ovf), int(total))
        both = parallel.all_reduce(
            mesh, torch.tensor([int(ovf), int(total)]), dist.ReduceOp.MAX)
        warned = any("key capacity overflow" in str(w.message)
                     for w in caught)
        return local, both.tolist(), warned

    out["overflow_4096"] = render(4096)
    total_max = out["overflow_4096"][1][1]
    out["overflow_half"] = render(max(1, total_max // 2))
    out["kcap_half"] = max(1, total_max // 2)

    # make_view_mesh: too many devices, a smaller mesh, no card
    try:
        parallel.make_view_mesh(RANKS + 1, device="cpu")
        out["too_many"] = ""
    except ValueError as e:
        out["too_many"] = str(e)
    sub = parallel.make_view_mesh(1, device="cpu")
    out["sub"] = None if sub is None else [sub.rank, sub.size,
                                           str(sub.device)]
    if not torch.cuda.is_available():
        try:
            parallel.make_view_mesh()
            out["no_card"] = ""
        except RuntimeError as e:
            out["no_card"] = str(e)
    return out


def tet_rank():
    """Every tet check on one rank of the 2-rank mesh."""
    mesh = parallel.make_view_mesh(device="cpu")
    scene, geom_np, batch_np = tet_problem()
    geom, bg = _tet_geom(geom_np), torch.zeros(3)
    batch = parallel.shard_view_batch(
        mesh, tet_view_batch_from_numpy(*batch_np, device="cpu"))
    out = {}
    for seed in (0, 3):
        step = tdm.make_tet_train_step(geom, bg, H, W, mesh=mesh, seed=seed)
        st, loss = step(_tet_state(scene, _sgd, mesh), batch)
        out[f"sgd_{seed}"] = _sgd_result(st, loss)
        out[f"sgd_{seed}_digest"] = digest(st.scene)
        _, out[f"sgd_{seed}_more"], out[f"sgd_{seed}_digests"] = _steps(
            step, st, batch, 5)
    # the ranks' active counts differ: a mean of per-rank means is wrong
    scene_u, _g, batch_u = tet_problem(uneven=True)
    local_u = parallel.shard_view_batch(
        mesh, tet_view_batch_from_numpy(*batch_u, device="cpu"))
    step = tdm.make_tet_train_step(geom, bg, H, W, mesh=mesh)
    out["uneven_count"] = float(tdm.make_tet_se_fn(geom, bg, H, W)(
        _tet_state(scene_u, _sgd).scene, local_u)[1])
    out["sgd_uneven"] = _sgd_result(*step(_tet_state(scene_u, _sgd, mesh),
                                          local_u))
    loop = tdm.make_tet_train_loop(geom, bg, H, W, 5, mesh=mesh)
    st, losses = loop(_tet_state(scene, _adam, mesh), batch)
    out["loop_losses"] = losses.tolist()
    out["loop_digest"] = digest(st.scene)
    step = tdm.make_tet_train_step(geom, bg, H, W, mesh=mesh)
    st = _tet_state(scene, _adam, mesh)
    out["adam_step_loss"] = float(step(st, batch)[1])
    out["captured"] = [step._captured(st, batch),
                       loop.step._captured(st, batch)]

    # the record overflow flag rides in the summed buffer after the squared
    # error and the count: rank 0's flag reaches every rank
    p = torch.zeros(3, requires_grad=True)
    p.grad = torch.full((3,), float(mesh.rank + 1))
    loss, sums = tdm._sum_over_views(
        mesh, [p], [torch.tensor(2.0), torch.tensor(4.0),
                    torch.tensor(float(mesh.rank == 0))],
        lambda flat: torch.clamp_min(flat[-2], 1.0))
    out["summed_flag"] = {"loss": float(loss), "sums": sums.tolist(),
                          "grad": p.grad.tolist()}
    return out


@pytest.fixture(scope="module")
def tri_runs():
    return parallel.spawn(tri_rank, RANKS, timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def tet_runs():
    return parallel.spawn(tet_rank, RANKS, timeout=SPAWN_TIMEOUT)


# ---------------------------------------------------- one-process and JAX

def port_tri_sgd(force):
    scene, faces, batch_np = tri_problem()
    step = tdm.make_train_step(torch.from_numpy(faces), torch.zeros(3), H, W,
                               force=force)
    return _sgd_result(*step(_tri_state(scene, _sgd),
                             view_batch_from_numpy(*batch_np, device="cpu")))


def port_tet(seed, opt, n, uneven=False):
    scene, geom_np, batch_np = tet_problem(uneven)
    step = tdm.make_tet_train_step(_tet_geom(geom_np), torch.zeros(3), H, W,
                                   seed=seed)
    batch = tet_view_batch_from_numpy(*batch_np, device="cpu")
    st, loss = step(_tet_state(scene, opt), batch)
    first = _sgd_result(st, loss)
    _, more, _ = _steps(step, st, batch, n)
    return first, more


def jax_tri_sharded(force):
    """JAX's sharded loss and gradients on its 2-device view mesh."""
    import jax
    import jax.numpy as jnp

    from dmesh_renderer_tpu.models import dmesh as jdm
    from dmesh_renderer_tpu.parallel.sharding import (
        make_view_mesh, shard_view_batch,
    )

    scene, faces, batch = tri_problem()
    mesh = make_view_mesh(RANKS)
    loss_fn = jdm.make_loss_fn(jnp.asarray(faces), jnp.zeros(3, jnp.float32),
                               H, W, force=force)
    vg = jax.jit(jdm._make_sharded_value_and_grad(loss_fn, mesh))
    loss, grads = vg(jdm.TriScene(*map(jnp.asarray, scene)),
                     shard_view_batch(mesh, jdm.ViewBatch(
                         *map(jnp.asarray, batch))))
    return float(loss), [np.asarray(g) for g in grads]


def jax_tet_sharded(seed):
    """JAX's sharded tet loss and gradients on its 2-device view mesh."""
    import jax
    import jax.numpy as jnp

    from dmesh_renderer_tpu.models import dmesh as jdm
    from dmesh_renderer_tpu.parallel.sharding import (
        make_view_mesh, shard_view_batch,
    )

    scene, geom, batch = tet_problem()
    mesh = make_view_mesh(RANKS)
    se_fn = jdm.make_tet_se_fn(jdm.TetGeometry(*map(jnp.asarray, geom)),
                               jnp.zeros(3, jnp.float32), H, W, seed)
    vg = jax.jit(jdm._make_tet_vg(se_fn, mesh))
    loss, grads = vg(jdm.TetScene(*map(jnp.asarray, scene)),
                     shard_view_batch(mesh, jdm.TetViewBatch(
                         *map(jnp.asarray, batch))))
    return float(loss), [np.asarray(g) for g in grads]


def _check_against_one_process(runs, key, one, loss_rtol):
    r0, r1 = runs[0][key], runs[1][key]
    assert r0["loss"] == r1["loss"]
    for a, b in zip(r0["scene"], r1["scene"]):
        assert torch.equal(a, b), "ranks' parameters differ"
    assert np.isclose(one["loss"], r0["loss"], rtol=loss_rtol)
    for a, b in zip(one["scene"], r0["scene"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=1e-7)


def _check_against_jax(result, j_loss, j_grads):
    assert _rel(result["loss"], j_loss) <= 1e-5
    for g, j in zip(result["grads"], j_grads):
        assert bool(g.any())
        assert _rel(g.numpy(), j) <= 1e-4


# -------------------------------------------------------------- tri tests

@pytest.mark.parametrize("force", [None, "binned"])
def test_sharded_step_matches_single_device(tri_runs, force):
    """``test_sharding.py:43`` (auto: the dense oracle at this size) and
    ``:69`` (the tile-binned path, forced): one SGD step on 2 ranks equals
    the one-process step and JAX's sharded step."""
    assert [r["local_views"] for r in tri_runs] == [B // RANKS] * RANKS
    _check_against_one_process(tri_runs, f"sgd_{force}", port_tri_sgd(force),
                               loss_rtol=1e-6)
    _check_against_jax(tri_runs[0][f"sgd_{force}"], *jax_tri_sharded(force))


def test_training_reduces_loss(tri_runs):
    """``test_sharding.py:99``: Adam(5e-2) under the mesh lowers the loss,
    and both ranks hold the same bits after every step."""
    r0, r1 = tri_runs
    assert r0["adam_losses"] == r1["adam_losses"]
    assert r0["adam_digests"] == r1["adam_digests"]
    assert r0["adam_losses"][-1] < r0["adam_losses"][0]


def test_train_loop(tri_runs):
    """``test_sharding.py:115``: the loop under the mesh takes the steps of
    the sharded step, bit for bit, and lowers the loss."""
    r0, r1 = tri_runs
    assert r0["loop_losses"] == r1["loop_losses"]
    assert r0["loop_digest"] == r1["loop_digest"] == r0["adam_digests"][4]
    assert r0["loop_losses"] == r0["adam_losses"][:5]
    assert r0["loop_losses"][-1] < r0["loop_losses"][0]


def test_view_params_state_accepted_under_mesh(tri_runs):
    """``test_sharding.py:311``: per-view params in the state pass through
    the sharded step unchanged."""
    for r in tri_runs:
        vp = r["view_params"]
        assert np.isfinite(vp["loss"]) and vp["same"] and vp["bits_kept"]


def test_overflow_flag_propagates_under_mesh(tri_runs):
    """``test_sharding.py:333``: a per-rank key-capacity overflow is seen on
    every rank after a MAX all-reduce, with the largest emitted count; the
    overflow warning fires on the rank that overflowed."""
    for r in tri_runs:
        (_ovf, _tot), both, warned = r["overflow_4096"]
        assert both[0] == 0 and both[1] > 2 and not warned
    total_true = tri_runs[0]["overflow_4096"][1][1]
    kcap = tri_runs[0]["kcap_half"]
    assert any(r["overflow_4096"][0][1] == total_true for r in tri_runs)
    for r in tri_runs:
        (ovf, local_total), both, warned = r["overflow_half"]
        assert both == [1, total_true], "per-rank overflow lost"
        assert bool(ovf) == (local_total > kcap) == warned


def test_shard_view_batch_rejects_uneven_views():
    """``test_sharding.py:379``: views that do not divide the mesh fail
    fast with the fix in the message; an even batch gives each rank its
    rows."""
    _scene, _faces, batch_np = tri_problem()
    batch = view_batch_from_numpy(*batch_np, device="cpu")
    mesh = parallel.ViewMesh(None, 1, 8, torch.device("cpu"))
    odd = tdm.ViewBatch(*(x[:6] for x in batch))
    with pytest.raises(ValueError, match="6 views do not divide evenly over "
                                         "the 8-device mesh"):
        parallel.shard_view_batch(mesh, odd)
    local = parallel.shard_view_batch(mesh, batch)
    assert type(local) is tdm.ViewBatch
    for x, y in zip(local, batch):
        assert torch.equal(x, y[1:2])


def test_make_view_mesh_errors(tri_runs):
    """``make_view_mesh`` needs an initialised group, takes at most its
    ranks (JAX's message), gives a smaller mesh to the first ranks only, and
    defaults to the card."""
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="not initialised"):
            parallel.make_view_mesh(device="cpu")
    for r in tri_runs:
        assert r["size"] == RANKS
        assert r["too_many"] == (
            "make_view_mesh: requested 3 devices but only 2 are available")
        assert r["sub"] == ([0, 1, "cpu"] if r["rank"] == 0 else None)
        if "no_card" in r:
            assert "no CUDA device is available" in r["no_card"]


def test_gloo_mesh_stays_eager(tri_runs, tet_runs):
    """A gloo mesh on the CPU is not one whose all-reduce a CUDA graph can
    hold: its steps and loops stay eager."""
    for r in tri_runs:
        assert r["captured"] == [False, False, False]
    for r in tet_runs:
        assert r["captured"] == [False, False]


def test_graph_capturable_predicate(monkeypatch):
    """``parallel.graph_capturable`` on stub meshes: NCCL on a card yes;
    gloo on a card no; the CPU no, whatever the backend."""
    backend = {}
    monkeypatch.setattr(dist, "get_backend", lambda group: backend["name"])
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    for name, dev, want in (("nccl", card, True), ("gloo", card, False),
                            ("gloo", cpu, False), ("nccl", cpu, False)):
        backend["name"] = name
        assert parallel.graph_capturable(
            parallel.ViewMesh(object(), 0, 2, dev)) is want


@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_step_loss_holds_no_gradients(tri_runs, tet_runs, kind):
    """The loss a step returns, sharded or not, is a scalar of its own: it
    shares no storage with the gradients (the flat buffer the sharded step
    reduces), so a caller that keeps every step's loss keeps 4 bytes a
    step, not the buffer."""
    if kind == "tri":
        results = [r[f"sgd_{f}"] for r in tri_runs for f in (None, "binned")]
        results.append(port_tri_sgd(None))
    else:
        results = [r[k] for r in tet_runs
                   for k in ("sgd_0", "sgd_3", "sgd_uneven")]
        results.append(port_tet(0, _sgd, 0)[0])
    for r in results:
        assert r["loss_bytes"] == 4 and not r["loss_holds_grads"]


# -------------------------------------------------------------- tet tests

@pytest.mark.parametrize("seed", [0, 3])
def test_tet_sharded_step_matches_single_device(tet_runs, seed):
    """``test_sharding.py:131``: one SGD tet step on 2 ranks equals the
    one-process step (the masked loss sums the squared error and the active
    count over the ranks before dividing) and JAX's sharded step; seed 3
    keys each rank's jitter by the global view index. Training then
    progresses, with both ranks' bits equal after every step."""
    key = f"sgd_{seed}"
    one, _ = port_tet(seed, _sgd, 0)
    assert np.isfinite(one["loss"]) and one["loss"] > 0
    _check_against_one_process(tet_runs, key, one, loss_rtol=2e-5)
    _check_against_jax(tet_runs[0][key], *jax_tet_sharded(seed))
    r0, r1 = tet_runs
    assert r0[f"{key}_digest"] == r1[f"{key}_digest"]
    assert r0[f"{key}_digests"] == r1[f"{key}_digests"]
    assert r0[f"{key}_more"][-1] < r0[key]["loss"]


def test_tet_sharded_step_uneven_counts(tet_runs):
    """The ranks' active counts differ (rank 1's views from twice as far):
    the 2-rank step still equals the one-process step, because the squared
    error, the count and the gradients are summed over the ranks before
    the one division by the global count."""
    counts = [r["uneven_count"] for r in tet_runs]
    assert counts[0] > 1.2 * counts[1] > 0
    one, _ = port_tet(0, _sgd, 0, uneven=True)
    _check_against_one_process(tet_runs, "sgd_uneven", one, loss_rtol=2e-5)
    for g, want in zip(tet_runs[0]["sgd_uneven"]["grads"], one["grads"]):
        assert _rel(g.numpy(), want.numpy()) <= 1e-5


def test_tet_sharded_fallback_with_jitter_matches(tet_runs, monkeypatch):
    """``test_sharding.py:197``: JAX's marching-backward fallback (walks
    deeper than its replay log, ``LOG_CAP`` 2) regenerates jittered rays
    per global view. The port has no replay log: its backward always
    re-walks, so its 2-rank seed-3 step is held against JAX's sharded step
    on the fallback."""
    import dmesh_renderer_tpu.ops.tet as jtet

    monkeypatch.setattr(jtet, "LOG_CAP", 2)
    _check_against_jax(tet_runs[0]["sgd_3"], *jax_tet_sharded(3))


def test_summed_overflow_flag(tet_runs):
    """The tet step's record overflow flag is the last scalar of the flat
    buffer: rank 0 flags (1) and rank 1 does not (0), and both read back 1,
    so both redo the step; the count beside it and the gradients are
    summed, and the gradients and the loss divided by the count."""
    for r in tet_runs:
        f = r["summed_flag"]
        assert f["sums"] == [8.0, 1.0]
        assert f["loss"] == 0.5 and f["grad"] == [0.375] * 3


def test_tet_train_loop(tet_runs):
    """``test_sharding.py:251``: the tet loop under the mesh lowers the
    loss, its first step equals one sharded step, and it agrees with the
    one-process loop."""
    r0, r1 = tet_runs
    losses = np.array(r0["loop_losses"])
    assert r0["loop_losses"] == r1["loop_losses"]
    assert r0["loop_digest"] == r1["loop_digest"]
    assert losses.shape == (5,) and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses[0], r0["adam_step_loss"], rtol=1e-6)
    first, more = port_tet(0, _adam, 4)
    np.testing.assert_allclose(losses, [first["loss"], *more], rtol=2e-5)
