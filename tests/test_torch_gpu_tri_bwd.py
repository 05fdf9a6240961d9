"""The torch port's backward kernels on the card: K2 and seg_sum against
their plain versions, bitwise-deterministic gradients, and the card's
gradients against the CPU port and the golden.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX, so it runs where only PyTorch is installed:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_tri_bwd.py

Tolerances: K2's records within 1e-6 relative of its plain version (the
same f32 operations and the same sum order; both built without FMA
contraction); seg_sum bit for bit; every stage of the binned path and its
five gradients bit for bit equal to the CPU port's, since each stage does
the same f32 operations in the same order on both devices (ops/rays.py
divides by a tensor and takes its root in f64 for this: CUDA divides by a
Python scalar through its reciprocal, and torch's CPU sqrt is not
correctly rounded; the last-bit ray differences these gave moved the verts
gradient by up to 3.4e-5 relative at mid_600 on an H100); and within the
golden's 1e-4 (binned) and 1e-5 (oracle).
"""

import os

import numpy as np
import pytest
import torch

from dmesh_renderer_tpu_torch.convert import tri_inputs_from_numpy
from dmesh_renderer_tpu_torch.ops import reduce as trd
from dmesh_renderer_tpu_torch.ops import tri_binned as ttb
from dmesh_renderer_tpu_torch.ops.tri import render_tri_auto
import scenes

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tri_scene.npz")
DIFF = (0, 2, 3, 8, 9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _soup_args(n_tris, n_views, seed, bg=(0.15, 0.25, 0.35)):
    soup = scenes.random_triangle_soup(n_tris, seed=seed)
    mv, proj = scenes.ring_cameras(n_views, radius=3.0)
    vd, fi = scenes.soup_view_attrs(soup, n_views, seed=seed + 1)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    return (soup["verts"], soup["faces"], soup["verts_color"],
            soup["faces_opacity"], mv_t, proj_t, np.linalg.inv(mv_t),
            np.linalg.inv(proj_t), vd, fi, np.asarray(bg, np.float32))


def _rel(got, want):
    got = got.double().cpu()
    want = torch.as_tensor(np.asarray(want)).double()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


# (n_tris, views, seed, H, W): the golden scene, the binned-test fixture
# (48x40), an image that is no multiple of 16 (33x40), a mid-size scene
CASES = {
    "golden": (16, 2, 42, 32, 32),
    "binned_fixture": (24, 2, 13, 48, 40),
    "odd_33x40": (60, 1, 102, 33, 40),
    "mid_600": (600, 2, 5, 72, 56),
}


@pytest.mark.parametrize("case", list(CASES))
def test_k2_matches_plain(case, cuda):
    n, b, seed, h, w = CASES[case]
    t = tri_inputs_from_numpy(*_soup_args(n, b, seed), device=cuda)
    _c, _d, _keys, inputs, state = ttb._forward(*t, h, w, 8192, None)
    g = torch.Generator().manual_seed(seed)
    gin = torch.randn((b, 5, h, w), generator=g).to(cuda)
    before = ttb.bwd_composite.launches
    got = ttb.bwd_composite(*inputs[:6], *state, gin, *inputs[6:])
    torch.cuda.synchronize()
    assert ttb.bwd_composite.launches == before + 1
    want = ttb.bwd_composite_plain(*inputs[:6], *state, gin, *inputs[6:])
    assert bool((want != 0).any())
    assert _rel(got, want.cpu()) <= 1e-6


def test_seg_sum_bitwise(cuda):
    rng = np.random.RandomState(4)
    n, n_seg, C = 200_000, 5000, 22
    ids = torch.from_numpy(rng.randint(0, n_seg, size=n)).to(cuda)
    vals = torch.from_numpy(rng.randn(n, C).astype(np.float32)).to(cuda)
    csr = trd.segment_csr(ids, n_seg, inner=1)
    before = trd.seg_sum.launches
    got = trd.seg_sum(vals, csr)
    torch.cuda.synchronize()
    assert trd.seg_sum.launches == before + 1
    assert torch.equal(got, trd.seg_sum_plain(vals, csr))


def _seg_case(case, dev):
    """(values, csr) of one seg_sum edge case, made with numpy from a
    seed: random segments with empty ones at C of 1, 10, 22 and 6 + B for
    B of 1 and 2 (the main path's column counts), and 33 and 70 (more
    columns than a warp's lanes); rows not 8-byte aligned; no rows; no
    segments; one segment of 100k rows; ``inner`` 4."""
    rng = np.random.RandomState(11)
    n, n_seg = 50_000, 3000
    inner = 1
    if case.startswith("C="):
        C = int(case[2:])
        ids = rng.randint(0, n_seg, size=n)
        ids = np.where(ids % 5 == 0, n_seg - 1, ids)  # many empty segments
    elif case == "unaligned":
        C, ids = 10, rng.randint(0, n_seg, size=n)
    elif case == "no rows":
        C, ids = 10, np.zeros(0, np.int64)
    elif case == "no segments":
        C, n_seg, ids = 22, 0, np.zeros(0, np.int64)
    elif case == "one 100k segment":
        C, n_seg, ids = 10, 1, np.zeros(100_000, np.int64)
    else:
        assert case == "inner 4"
        C, inner, ids = 22, 4, rng.randint(0, n_seg, size=n // 4)
    rows = len(ids) * inner
    buf = torch.from_numpy(rng.randn(rows * C + 1).astype(np.float32))
    # a view one float into the buffer is 4 bytes off 8-byte alignment
    start = 1 if case == "unaligned" else 0
    vals = buf.to(dev)[start:start + rows * C].view(rows, C)
    csr = trd.segment_csr(torch.from_numpy(ids).to(dev), n_seg, inner=inner)
    return vals, csr


@pytest.mark.parametrize("case", [
    "C=1", "C=10", "C=22", "C=7", "C=8", "C=33", "C=70", "unaligned",
    "no rows", "no segments", "one 100k segment", "inner 4"])
def test_seg_sum_edge_cases_bitwise(case, cuda):
    """seg_sum on the card against its plain version, bit for bit, at the
    shapes and edges its lane layout treats apart."""
    vals, csr = _seg_case(case, cuda)
    before = trd.seg_sum.launches
    got = trd.seg_sum(vals, csr)
    torch.cuda.synchronize()
    n_seg = csr.offsets.numel() - 1
    assert trd.seg_sum.launches == before + 1
    assert got.shape == (n_seg, vals.shape[1])
    want = trd.seg_sum_plain(vals, csr)
    assert torch.equal(got, want)
    if vals.shape[0] and n_seg:
        assert bool(want.any())


def _grads(t, h, w, force, loss_w):
    t = list(t)
    for i in DIFF:
        t[i] = t[i].clone().requires_grad_(True)
    c, d = render_tri_auto(*t, h, w, force=force)
    wc, wd = loss_w
    ((c * wc.to(c.device)).sum() + (d * wd.to(d.device)).sum()).backward()
    return [t[i].grad for i in DIFF]


@pytest.mark.parametrize("case", ["mid_600", "odd_33x40"])
def test_grads_deterministic_and_match_cpu(case, cuda):
    n, b, seed, h, w = CASES[case]
    args = _soup_args(n, b, seed)
    rng = np.random.RandomState(seed)
    loss_w = (torch.from_numpy(rng.randn(b, 3, h, w).astype(np.float32)),
              torch.from_numpy(rng.randn(b, 1, h, w).astype(np.float32)))
    tc = tri_inputs_from_numpy(*args, device=cuda)
    k2, ss = ttb.bwd_composite.launches, trd.seg_sum.launches
    g1 = _grads(tc, h, w, "binned", loss_w)
    torch.cuda.synchronize()
    assert ttb.bwd_composite.launches == k2 + 1
    assert trd.seg_sum.launches == ss + 2  # records, then vertices
    g2 = _grads(tc, h, w, "binned", loss_w)
    for x, y in zip(g1, g2):
        assert torch.equal(x, y)
    gcpu = _grads(tri_inputs_from_numpy(*args, device="cpu"), h, w,
                  "binned", loss_w)
    for x, y in zip(g1, gcpu):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("case", ["mid_600", "odd_33x40"])
def test_stages_match_cpu(case, cuda):
    """Every stage of the binned forward and backward gives the same bits
    on the card as on the CPU: keys, depth-sorted face tables, rays, K1's
    outputs, the upstream planes, K2's records and the five gradients."""
    n, b, seed, h, w = CASES[case]
    args = _soup_args(n, b, seed)
    rng = np.random.RandomState(seed)
    dc = torch.from_numpy(rng.randn(b, 3, h, w).astype(np.float32))
    dd = torch.from_numpy(rng.randn(b, 1, h, w).astype(np.float32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        t = tri_inputs_from_numpy(*args, device=dev)
        c, d, keys, inputs, state = ttb._forward(*t, h, w, 8192, None)
        gin = ttb.upstream_planes(dc.to(dev), dd.to(dev), t[10])
        rec = ttb.bwd_composite(*inputs[:6], *state, gin, b, h, w)
        grads = ttb.reduce_records(rec, keys.slot_face, keys.sigma,
                                   inputs[3], t[1], t[9], t[0].shape[0])
        names = ("starts", "ends", "slot_face", "face_f32", "face_i32",
                 "ray_d", "T", "prevT", "n_contrib", "color", "depth",
                 "sigma", "gin", "records", "g_verts", "g_vcolor", "g_fop",
                 "g_vdepth", "g_fint")
        out[dev.type] = dict(zip(names, (*inputs[:6], *state, c, d,
                                         keys.sigma, gin, rec, *grads)))
    differ = [k for k, v in out["cpu"].items()
              if not torch.equal(out["cuda"][k].cpu(), v)]
    assert not differ, differ


@pytest.mark.parametrize("force,tol", [("oracle", 1e-5), ("binned", 1e-4)])
def test_card_grads_match_golden(force, tol, cuda):
    """The scene and loss of test_golden.py, on the card."""
    golden = dict(np.load(GOLDEN))
    t = list(tri_inputs_from_numpy(*_soup_args(16, 2, 42, bg=(0.2, 0.1,
                                                              0.3)),
                                   device=cuda))
    leaves = [t[i].clone().requires_grad_(True) for i in DIFF]
    v, vc, fo, vd, fi = leaves
    c, d = render_tri_auto(t[0], t[1], vc, fo, *t[4:8], vd, fi, t[10], 32,
                           32, force=force)
    c2, d2 = render_tri_auto(v, *t[1:10], t[10], 32, 32, force=force)
    ((c * c).sum() + d.sum() + (c2 * d2).sum()).backward()
    for k, leaf in zip(("g_verts", "g_vcolor", "g_fop", "g_vdepth",
                        "g_fint"), leaves):
        assert _rel(leaf.grad, golden[k]) < tol, k
