"""The tet frame at static capacities, on the CPU.

Every tensor of a tet frame is sized from B, F, H, W and the capacities,
never from the scene: two scenes of the same sizes give first-hit keys, K5
records and a record CSR of the same shapes, sized by the key capacity and
the record capacity ``record_capacity`` = B * H * W * min(``LOG_CAP``,
max_steps). The static bbox emission equals the JAX package's at the same
capacity, with and without overflow. A record total past the capacity
takes the exact fallback (gradients bitwise those of the full capacity);
an eager frame reads the host once and warns once, and under a capture
nothing is read and the record overflow stays a device flag.
``make_tet_train_loop`` takes the JAX package's ``lax.scan`` loop's steps
(``test_torch_tet_train.py``'s tolerances). The card's side -- the
captured step, loop and frame, bitwise against eager ones, and the host
syncs -- is ``test_torch_gpu_tet_graph.py``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmesh_renderer_tpu.models import dmesh as jdm
import dmesh_renderer_tpu.ops.binning as jbin
from dmesh_renderer_tpu_torch.models import dmesh as tdm
from dmesh_renderer_tpu_torch.ops import binning as tb
from dmesh_renderer_tpu_torch.ops import geometry as tg
from dmesh_renderer_tpu_torch.ops import reduce as rd
from dmesh_renderer_tpu_torch.ops import tet as pt
from dmesh_renderer_tpu_torch.utils import connectivity, scenes
from test_torch_tet_fwd import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tet_train import (  # noqa: F401  (problem: a fixture)
    LR, H as TRAIN_H, W as TRAIN_W, PARAM_ATOL, _port_geom, _port_state,
    problem,
)
from test_torch_train import _rel

H, W = 40, 48
GRID = 3
CONTEXT = "tet first hit; a dropped face cannot be hit"


def _args(gseed, views=2):
    """A jittered Freudenthal grid (``gseed`` moves its vertices, so its
    pair and record counts; its sizes stay) as ``render_tet_core``'s
    thirteen CPU tensors, the face opacities drawn from ``gseed`` too."""
    v, tets = connectivity.freudenthal_grid(GRID, 0.15, gseed)
    f, ft, tf = connectivity.build_tet_connectivity(tets)
    rng = np.random.RandomState(gseed)
    vc = rng.rand(v.shape[0], 3).astype(np.float32)
    fo = rng.uniform(0.2, 0.9, f.shape[0]).astype(np.float32)
    fi = rng.uniform(0.5, 1.0, (views, f.shape[0])).astype(np.float32)
    mv, proj = scenes.ring_cameras(views)
    t = lambda a, d=torch.float32: torch.from_numpy(
        np.ascontiguousarray(a)).to(d)
    mv_t = t(np.swapaxes(mv, 1, 2))
    proj_t = t(np.swapaxes(proj, 1, 2))
    inv = tg.inverse44(torch.stack([mv_t, proj_t]))
    i32 = torch.int32
    return (t(v), t(f, i32), t(vc), t(fo), mv_t, proj_t, inv[0], inv[1],
            t(fi), t(tets, i32), t(ft, i32), t(tf, i32),
            torch.tensor([0.1, 0.2, 0.3]))


def _upstream(B, seed=5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, 3, H, W), generator=g),
            torch.randn((B, 1, H, W), generator=g))


def _grads(args, gc, gd, kcap=None):
    """The tet render's two gradients for the upstream ``gc``/``gd``."""
    args = list(args)
    for i in (2, 3):
        args[i] = args[i].clone().requires_grad_(True)
    c, d, _a = pt.render_tet_core(*args, H, W, 0, kcap=kcap)
    ((c * gc).sum() + (d * gd).sum()).backward()
    return args[2].grad, args[3].grad


def _pre(args):
    ndc, img = tg.project_verts(args[0], args[4], args[5], W, H)
    return tg.preprocess_faces(ndc, img, args[1], W, H, 32, 32)


@pytest.fixture(autouse=True)
def binned(monkeypatch):
    """The binned first hit (K3's path) on these small scenes."""
    monkeypatch.setattr(pt, "BINNED_FIRST_HIT_THRESHOLD", 1)


def test_shapes_do_not_follow_the_scene():
    """Two scenes of the same B, F, H, W with different pair and record
    counts: the first hit's keys, K5's keys and records and the record
    CSR have the same shapes, sized by the key and record capacities;
    only the live prefixes differ."""
    shapes, live = [], []
    for gseed in (2, 7):
        args = _args(gseed)
        B, F = args[4].shape[0], args[1].shape[0]
        kcap = tb.default_key_capacity(B, F, avg_tiles_per_face=5)
        keys = tb.emit_and_sort(_pre(args), 2, 2, kcap, sort_by="min_depth")
        _c, _d, _a, saved = pt.render_tet_forward(*args, H, W, 0)
        ray_i, ray_f, off, cap, total, ovf = pt.bwd_start_state(
            saved, args[10], *_upstream(B), args[12])
        m = saved["march"]
        k, rec, _bad = pt.bwd_march(saved["ray_d"], saved["cam_o"],
                                    saved["zw"], ray_i, ray_f, off, cap,
                                    m["tet_geo"], m["tet_nrm"], m["tet_ids"],
                                    m["shade"], H * W)
        csr = rd.segment_csr(k, F)
        shapes.append([tuple(x.shape) for x in (*keys[:4], k, rec, *csr)])
        live.append((int(keys.total), int(total)))
        R = pt.record_capacity(B, H, W, 512)
        assert keys.slot_face.numel() == kcap and cap == R == B * H * W * 24
        assert rec.shape == (R, pt.REC_COLS) and not bool(ovf)
        assert int(csr.offsets[-1]) == int(total) < R
    assert shapes[0] == shapes[1]
    assert live[0][0] != live[1][0] and live[0][1] != live[1][1]


@pytest.mark.parametrize("cut", ["none", "half"])
def test_bbox_emission_matches_jax(cut):
    """The static bbox emission against the JAX package's bbox path
    (``emit_and_sort(sort_by="min_depth")`` without ``tile_px``) on the same
    per-face rects and depths, at a capacity above the pair count and at
    one that drops half the pairs: the live slots' faces, the tile ranges,
    the total and the flag."""
    args = _args(2)
    pre = _pre(args)
    total = int(pre["tiles"].sum())
    kcap = 2 * total if cut == "none" else total // 2
    keys = tb.emit_and_sort(pre, 2, 2, kcap, sort_by="min_depth")
    jpre = {k: jnp.asarray(pre[k].numpy())
            for k in ("tiles", "rect_min", "rect_max", "depth", "min_depth")}
    raw = jax.jit(lambda p: jbin.emit_and_sort(
        p, 2, 2, kcap, sort_by="min_depth"))(jpre)
    n = min(total, kcap)
    assert int(keys.total) == int(raw.total) == total
    assert bool(keys.overflow) == bool(raw.overflow) == (cut == "half")
    assert int(keys.ends[-1]) == n and keys.slot_face.numel() == kcap
    np.testing.assert_array_equal(keys.starts.numpy(), np.asarray(raw.starts))
    np.testing.assert_array_equal(keys.ends.numpy(), np.asarray(raw.ends))
    np.testing.assert_array_equal(keys.slot_face[:n].numpy(),
                                  np.asarray(raw.sorted_id)[:n])
    assert bool((keys.slot_face[n:] == args[1].shape[0] * 2).all())


def test_forced_record_overflow_is_exact(monkeypatch):
    """With the record capacity at one record a ray (``LOG_CAP`` 1) the
    records pass it; the eager frame's one read sees that and its backward
    runs at the records' size: both gradients bitwise those at the full
    capacity, and no overflow left flagged."""
    args = _args(2)
    up = _upstream(2)
    want = _grads(args, *up)
    monkeypatch.setattr(pt, "LOG_CAP", 1)
    _c, _d, _a, saved = pt.render_tet_forward(*args, H, W, 0)
    assert saved["record_capacity"] > pt.record_capacity(2, H, W, 512)
    got = _grads(args, *up)
    for a, b in zip(got, want):
        assert torch.equal(a, b) and bool(a.any())
    assert not bool(pt.render_tet_backward.overflow)


def _counting_reads(monkeypatch):
    reads = []
    real = tb.host_read

    def counted(*values):
        reads.append(len(values))
        return real(*values)

    monkeypatch.setattr(tb, "host_read", counted)
    return reads


def test_eager_frame_reads_once_and_warns_once(monkeypatch):
    """An eager training frame (forward and backward) at a key capacity
    that drops pairs makes one host read of three values and warns once,
    in the JAX package's wording."""
    args = _args(2)
    reads = _counting_reads(monkeypatch)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _grads(args, *_upstream(2), kcap=64)
    msgs = [str(w.message) for w in rec]
    assert reads == [3] and len(msgs) == 1
    assert CONTEXT in msgs[0] and "> capacity 64)" in msgs[0]


@pytest.mark.parametrize("log_cap", [24, 1])
def test_capture_reads_nothing(monkeypatch, log_cap):
    """With a capture pretended (``binning.is_capturing``), a training frame
    at an overflowing key capacity reads and warns nothing. Its backward
    holds the records at the static capacity: at ``LOG_CAP`` 24 the
    gradients are the eager frame's bit for bit and the record flag is
    clear; at ``LOG_CAP`` 1 records are dropped and the flag, a tensor left
    for the caller to read, is set."""
    args = _args(2)
    up = _upstream(2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _grads(args, *up, kcap=64)
    monkeypatch.setattr(pt, "LOG_CAP", log_cap)
    reads = _counting_reads(monkeypatch)
    monkeypatch.setattr(tb, "is_capturing", lambda device: True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = _grads(args, *up, kcap=64)
    flag = pt.render_tet_backward.overflow
    assert reads == [] and isinstance(flag, torch.Tensor)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    assert same == (log_cap == 24) and bool(flag) == (log_cap == 1)


def test_tet_train_loop_matches_jax_scan(problem):  # noqa: F811
    """The port's ``make_tet_train_loop`` against the JAX package's
    (``jax.jit`` of a ``lax.scan`` over the steps), 3 Adam steps: losses
    within 1e-5 relative, parameters within ``PARAM_ATOL``."""
    p = problem
    opt = optax.adam(LR)
    geom = jdm.TetGeometry(*map(jnp.asarray, p["geom"]))
    loop = jdm.make_tet_train_loop(opt, geom, jnp.asarray(p["bg"]), TRAIN_H,
                                   TRAIN_W, 3)
    jstate = jdm.init_tet_train_state(
        jdm.TetScene(*map(jnp.asarray, p["scene"])), opt)
    jstate, jlosses = loop(jstate, jdm.TetViewBatch(*map(jnp.asarray,
                                                         p["batch"])))
    state, batch = _port_state(p)
    tloop = tdm.make_tet_train_loop(_port_geom(p), torch.from_numpy(p["bg"]),
                                    TRAIN_H, TRAIN_W, 3)
    state, losses = tloop(state, batch)
    assert losses.shape == (3,) and tloop.step.captures == 0  # the CPU
    assert _rel(losses.numpy(), np.asarray(jlosses)) <= 1e-5
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    assert float(losses[-1]) < float(losses[0])
    for q, j in zip(state.scene, jstate.scene):
        np.testing.assert_allclose(q.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=PARAM_ATOL)
