"""The torch port's tile binning against the JAX package, on CPU.

Exact emission counts, the emitted total (``num_rendered``), the overflow
flag and every tile's list of (view, face) ids in order must be identical,
under every capacity setting (key capacity, run capacity, bbox emission).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dmesh_renderer_tpu.ops import binning as jb
from dmesh_renderer_tpu_torch.ops import binning as tb
from dmesh_renderer_tpu_torch.ops import geometry as tg
from dmesh_renderer_tpu_torch.ops.tri_binned import render_tri_binned
from test_torch_geometry import jax_geometry, scene

TILE = 32


def _jax_emit(pre, gx, gy, kcap, **kw):
    """JAX emit_and_sort under jit (static grid and capacities)."""
    return jax.jit(lambda p: jb.emit_and_sort(p, gx, gy, kcap, **kw))(pre)


def _pre(name):
    a, t, h, w = scene(name)
    _ndc, _img, pre = jax_geometry(name)
    tndc, timg = tg.project_verts(t[0], t[4], t[5], w, h)
    tpre = tg.preprocess_faces(tndc, timg, t[1], w, h, TILE, TILE)
    gx, gy = (w + TILE - 1) // TILE, (h + TILE - 1) // TILE
    return a, t, h, w, pre, tpre, gx, gy


def _jax_lists(keys, n_tiles):
    """JAX's per-tile original-id lists, through the slab-aligned table."""
    cap = jb.aligned_capacity(int(keys.sorted_id.shape[0]), n_tiles, 32)
    al = jax.jit(lambda k: jb.align_to_slabs(k, n_tiles, 32, cap))(keys)
    flat, sigma = np.asarray(al.flat), np.asarray(al.sigma)
    st, en = np.asarray(al.starts), np.asarray(al.ends)
    ids = [sigma[flat[s:e]] for s, e in zip(st, en)]
    return np.concatenate(ids) if ids else np.zeros(0, int), en - st


def _assert_same_keys(keys, tk, n_tiles):
    """The same total, flag and tile lists; the live slots, ``ends[-1]``
    of them, come first, the rest of a static table hold the sentinel."""
    assert int(keys.total) == int(tk.total)
    assert bool(keys.overflow) == bool(tk.overflow)
    ids, counts = _jax_lists(keys, n_tiles)
    np.testing.assert_array_equal(counts, (tk.ends - tk.starts).numpy())
    n = int(tk.ends[-1])
    np.testing.assert_array_equal(ids, tk.sigma[tk.slot_face[:n].long()]
                                  .numpy())
    assert bool((tk.slot_face[n:] == tk.sigma.numel()).all())


@pytest.mark.parametrize("name", ["binned_fixture", "near_plane",
                                  "adversarial"])
def test_counts_total_and_tile_lists_exact(name):
    a, t, h, w, pre, tpre, gx, gy = _pre(name)
    counts = np.asarray(jax.jit(
        lambda p: jb.exact_tile_counts(p, gx, gy, TILE))(pre))
    np.testing.assert_array_equal(
        counts, tb.exact_tile_counts(tpre, gx, gy, TILE).numpy())
    n_tiles = a[4].shape[0] * gx * gy
    keys = _jax_emit(pre, gx, gy, 1 << 16, tile_px=TILE)
    tk = tb.emit_and_sort(tpre, gx, gy, 1 << 16, tile_px=TILE)
    assert int(tk.total) == int(counts.sum()) > 0
    _assert_same_keys(keys, tk, n_tiles)
    if name == "near_plane":  # the scene takes the full-rect branch
        assert bool(torch.any(tb._edge_wrap_risk(tpre, gx, gy, TILE)
                              & (tpre["tiles"] > 0)))


@pytest.mark.parametrize("case", ["kcap_cut", "kcap_tiny", "run_cap_1024",
                                  "run_cap_measured", "bbox"])
def test_capacity_policy_matches_jax(case):
    """Overflow, num_rendered and the kept pairs under a small key
    capacity, a small or measured run capacity, and bbox emission."""
    a, t, h, w, pre, tpre, gx, gy = _pre("binned_fixture")
    n_tiles = a[4].shape[0] * gx * gy
    total = int(tb.emit_and_sort(tpre, gx, gy, 8192, tile_px=TILE).total)
    kw = {"tile_px": TILE}
    kcap = 8192
    if case == "kcap_cut":
        kcap = total // 2
    elif case == "kcap_tiny":
        kcap = 16
    elif case == "run_cap_1024":
        kw["run_cap"] = 1024
    elif case == "run_cap_measured":
        kw["run_cap"] = tb.recommended_run_capacity(
            t[0], t[1], t[4], t[5], h, w, margin=1.25, bucket=128)
    else:
        kw = {}
    keys = _jax_emit(pre, gx, gy, kcap, **kw)
    tk = tb.emit_and_sort(tpre, gx, gy, kcap, **kw)
    _assert_same_keys(keys, tk, n_tiles)
    if case.startswith("kcap"):
        assert bool(tk.overflow) and int(tk.total) == total
        assert int(tk.slot_face.numel()) == kcap
    if case == "run_cap_measured":
        assert not bool(tk.overflow)
    if case == "bbox":
        assert int(tk.total) >= total


def test_recommended_capacities_match_jax():
    a, t, h, w = scene("binned_fixture")[:4]
    ja = [jnp.asarray(a[i]) for i in (0, 1, 4, 5)]
    for exact in (True, False):
        assert tb.recommended_key_capacity(
            t[0], t[1], t[4], t[5], h, w, margin=1.25, bucket=128,
            exact=exact) == jb.recommended_key_capacity(
            *ja, h, w, margin=1.25, bucket=128, exact=exact)
    assert tb.recommended_run_capacity(
        t[0], t[1], t[4], t[5], h, w, margin=1.25, bucket=128
    ) == jb.recommended_run_capacity(*ja, h, w, margin=1.25, bucket=128)
    assert tb.default_key_capacity(2, 24) == jb.default_key_capacity(2, 24)
    assert tb.run_capacity(48, 8192) == jb._run_capacity(48, 8192)


def test_drop_policy_is_farthest_first():
    """With the key capacity cut at the k-th nearest face's emission
    boundary, the image equals rendering only the k nearest faces."""
    a, t, h, w, pre, tpre, gx, gy = _pre("binned_fixture")
    one = [x[:1] for x in (t[4], t[5], t[6], t[7], t[8], t[9])]
    tndc, timg = tg.project_verts(t[0], one[0], one[1], w, h)
    p1 = tg.preprocess_faces(tndc, timg, t[1], w, h, TILE, TILE)
    tiles = tb.exact_tile_counts(p1, gx, gy, TILE)[0].numpy()
    key = np.where(tiles > 0, p1["depth"][0].numpy(), np.inf)
    order = np.argsort(key, kind="stable")
    csum = np.cumsum(tiles[order])
    k = len(order) // 2
    while k > 1 and csum[k - 1] == csum[-1]:
        k -= 1
    kcap = int(csum[k - 1])
    assert kcap < csum[-1]
    near = torch.from_numpy(np.sort(order[:k]))
    c_cut, _, (ovf, _n) = render_tri_binned(
        t[0], t[1], t[2], t[3], *one[:4], one[4], one[5], t[10], h, w, kcap,
        True)
    c_near, _ = render_tri_binned(
        t[0], t[1][near], t[2], t[3][near], *one[:4], one[4],
        one[5][:, near], t[10], h, w, kcap)
    assert bool(ovf)
    np.testing.assert_allclose(c_cut.numpy(), c_near.numpy(), atol=1e-6)
