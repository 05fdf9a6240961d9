"""The torch port's tet forward on its binned path against the JAX package,
on CPU: the adversarial scene (2,808 faces, so the binned first hit, whose
kernel K3 runs here as its plain version; seed 17, so jittered rays; cameras
inside the mesh; opacities of 1 and near 0).

The JAX side runs once, through its public ``render_tet`` with
``return_aux``, with the min-depth binning, the binned first hit and the
forward captured (see ``test_torch_tet_fwd``). Tolerances as there.
"""

import numpy as np
import pytest
import torch

import dmesh_renderer_tpu.ops.binning as jbin
import dmesh_renderer_tpu.ops.tet as jt
import dmesh_renderer_tpu.ops.tet_first_hit as jfh
from dmesh_renderer_tpu.api import TetRenderSettings as JSettings
from dmesh_renderer_tpu.api import render_tet as j_render_tet
from dmesh_renderer_tpu_torch import TetRenderSettings, render_tet
from dmesh_renderer_tpu_torch.convert import tet_args_from_numpy
from dmesh_renderer_tpu_torch.ops import binning as tb
from dmesh_renderer_tpu_torch.ops import geometry as tg
from dmesh_renderer_tpu_torch.ops import rays as tr
from dmesh_renderer_tpu_torch.ops import tet as pt
from dmesh_renderer_tpu_torch.ops import tet_first_hit as pfh
import test_golden_tet_adversarial as tga
from test_torch_tet_fwd import (  # noqa: F401 (one_torch_thread: autouse)
    FWD_ATOL, assert_forward_matches, assert_tuv_close, capturing,
    one_torch_thread, t2n, user_inputs,
)

H, W, B, SEED = tga.H, tga.W, tga.B, tga.SEED


@pytest.fixture(scope="module")
def adv():
    sc = tga._scene()
    u = user_inputs(sc)
    func = (*u[:4], np.swapaxes(u[4], 1, 2), np.swapaxes(u[5], 1, 2), *u[6:])
    store = {}
    with capturing(store, [(jt, "_render_tet_forward"),
                           (jfh, "first_intersection_binned"),
                           (jfh, "emit_and_sort")]):
        out = j_render_tet(*func, JSettings(H, W, sc[10],
                                            ray_random_seed=SEED),
                           return_aux=True)
    fwd_args = store["_render_tet_forward"][0][0]
    (verts, faces, vcolor, fopacity, mv_t, proj_t, fintense, tets, face_tets,
     tet_faces, bg) = sc
    t = tet_args_from_numpy(verts, faces, vcolor, fopacity, mv_t, proj_t,
                            np.asarray(fwd_args[6]), np.asarray(fwd_args[7]),
                            fintense, tets, face_tets, tet_faces, bg,
                            device="cpu")
    return sc, func, out, store, t


def port_pre(t):
    ndc, img = tg.project_verts(t[0], t[4], t[5], W, H)
    return tg.preprocess_faces(ndc, img, t[1], W, H, 32, 32)


@pytest.mark.parametrize("kcap", [None, 4096])
def test_min_depth_binning_matches_jax(adv, kcap):
    """Per-tile face lists, pair count and overflow equal JAX's
    ``emit_and_sort(sort_by="min_depth")`` before slab alignment, at the
    first hit's default capacity and at one that drops pairs. Both tables
    have ``kcap`` slots, the live ones first."""
    _sc, _func, _out, store, t = adv
    (pre_j, gx, gy, kcap_default), raw = store["emit_and_sort"][0]
    if kcap is not None:
        raw = jbin.emit_and_sort(pre_j, gx, gy, kcap, sort_by="min_depth")
    kcap = kcap or kcap_default
    keys = tb.emit_and_sort(port_pre(t), gx, gy, kcap, sort_by="min_depth")
    n = min(kcap, int(raw.total))
    assert int(keys.total) == int(raw.total) and int(keys.ends[-1]) == n
    assert keys.slot_face.numel() == kcap == raw.sorted_id.shape[0]
    assert bool(keys.overflow) == bool(raw.overflow) == (int(raw.total) > kcap)
    np.testing.assert_array_equal(t2n(keys.starts), np.asarray(raw.starts))
    np.testing.assert_array_equal(t2n(keys.ends), np.asarray(raw.ends))
    np.testing.assert_array_equal(t2n(keys.sigma), np.asarray(raw.sigma))
    np.testing.assert_array_equal(t2n(keys.slot_face)[:n],
                                  np.asarray(raw.sorted_id)[:n])


def test_first_hit_plain_matches_jax(adv):
    _sc, _func, _out, store, t = adv
    args, got = store["first_intersection_binned"][0]
    _v, _f, _pre, _img, cam_o, ray_d, h, w, b, kcap = args
    ff, rt, iu, iv, (ovf, total, walked) = pfh.first_intersection_binned(
        t[0], t[1], port_pre(t), torch.from_numpy(np.array(cam_o)),
        torch.from_numpy(np.array(ray_d)), h, w, b, kcap)
    np.testing.assert_array_equal(t2n(ff), np.asarray(got[0]))
    assert int((ff >= 0).sum()) > 0.5 * ff.numel()
    assert_tuv_close((rt, iu, iv), got[1:4])
    assert bool(ovf) == bool(got[4][0]) and int(total) == int(got[4][1])
    # each pair is staged at most once, by its tile's block
    assert 0 < int(walked) <= int(total)


@pytest.mark.parametrize("h, w", [(H, W), (40, 72)])
def test_first_hit_walked_rounds(adv, h, w):
    """``walked`` of the plain version: each tile's block stages its list
    in 32-slot rounds, the next one while it walks one, until at a round's
    start all of its pixels are done. At the scene's 48x48 (JAX's rays)
    and on a ragged 40x72 image (the port's rays), where tiles hold pixels
    past the image edge and lists run past two rounds."""
    _sc, _func, _out, store, t = adv
    gy, gx = (h + 31) // 32, (w + 31) // 32
    if (h, w) == (H, W):
        ray_d = torch.from_numpy(np.array(
            store["first_intersection_binned"][0][0][5]))
        pre = port_pre(t)
    else:
        ray_d = tr.generate_rays(t[6], t[7], w, h, norm_eps_mode="tet",
                                 jitter_seed=SEED)[1]
        ndc, img = tg.project_verts(t[0], t[4], t[5], w, h)
        pre = tg.preprocess_faces(ndc, img, t[1], w, h, 32, 32)
    keys = tb.emit_and_sort(pre, gx, gy, 1 << 16, sort_by="min_depth")
    table = pfh.build_first_hit_table(t[0], t[1], t[6][:, 3, :3],
                                      pre["min_depth"],
                                      pre["max_depth"])[keys.sigma]
    *res, visits = pfh.first_hit_plain(keys.starts, keys.ends,
                                       keys.slot_face, table, ray_d, B, h,
                                       w, with_visits=True)
    walked = res[4]
    count = (keys.ends - keys.starts).reshape(B, gy, gx)
    assert walked.shape == (B, gy, gx)
    assert bool((walked <= count).all())
    assert bool(((walked % pfh.ROUND == 0) | (walked == count)).all())
    assert bool((walked[count > 0] > 0).all())
    assert int(count.max()) > 2 * pfh.ROUND  # lists past two rounds
    # the same count from the pixels: a pixel that tested k faces and
    # stopped at slot k was done in round k // 32 (one that walked its
    # whole list, in its last); the block walks until its last pixel is
    # done and stages one round ahead
    pad = visits.new_zeros((B, gy * 32, gx * 32))
    pad[:, :h, :w] = visits
    last = pad.reshape(B, gy, 32, gx, 32).amax(dim=(2, 4))
    n_rounds = (count.long() + 31) // 32
    rounds = torch.minimum(n_rounds, last // 32 + 2)
    assert torch.equal(walked.long(), torch.minimum(count.long(), 32 * rounds))


def test_forward_matches_jax(adv):
    _sc, _func, _out, store, t = adv
    port = pt.render_tet_forward(*t, H, W, SEED)
    assert_forward_matches(port, store["_render_tet_forward"][0][1])
    saved = port[3]
    assert int(saved["n_contrib"].max()) > 8  # deep walks exercised
    assert int(saved["fh_num_rendered"]) > 0


def test_adversarial_golden(adv):
    golden = dict(np.load(tga.GOLDEN))
    _sc, _func, _out, _store, t = adv
    color, depth, active, _saved = pt.render_tet_forward(*t, H, W, SEED)
    np.testing.assert_array_equal(t2n(active), golden["active"])
    for k, got in (("color", color), ("depth", depth)):
        want = golden[k]
        err = np.abs(t2n(got) - want).max() / max(1.0, np.abs(want).max())
        assert err < FWD_ATOL, f"{k}: rel Linf {err}"


def test_render_tet_return_aux_matches_jax(adv):
    sc, func, out, _store, _t = adv
    c, d, a, (ovf, n) = render_tet(
        *func, TetRenderSettings(H, W, sc[10], ray_random_seed=SEED),
        return_aux=True, device="cpu")
    assert (bool(ovf), int(n)) == (bool(out[3][0]), int(out[3][1]))
    assert int(n) > 0 and not bool(ovf)
    np.testing.assert_array_equal(t2n(a), np.asarray(out[2]))
    np.testing.assert_allclose(t2n(c), np.asarray(out[0]), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(t2n(d), np.asarray(out[1]), rtol=0,
                               atol=FWD_ATOL)


def test_key_capacity_overflow(adv):
    sc, func, _out, _store, _t = adv
    *_r, (ovf, n) = render_tet(
        *func, TetRenderSettings(H, W, sc[10], key_capacity=128),
        return_aux=True, device="cpu")
    assert bool(ovf) and int(n) > 128


def test_jitter_keyed_by_global_view(adv):
    """Each view rendered alone with its ``view_offset`` equals the batch."""
    _sc, _func, _out, _store, t = adv
    full = pt.render_tet_core(*t, H, W, SEED)
    for b in range(B):
        tb_ = list(t)
        for i in (4, 5, 6, 7, 8):
            tb_[i] = t[i][b:b + 1]
        one = pt.render_tet_core(*tb_, H, W, SEED, view_offset=b)
        for x, y in zip(one, full):
            assert torch.equal(x[0], y[b])
