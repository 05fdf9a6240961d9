"""The torch port's tet kernels on the card: K3 (``first_hit``) and K4
(``fwd_march``) against their plain versions, the card against the CPU
stage by stage, and the renderer end to end.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX, so it runs where only PyTorch is installed:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_tet.py
"""

import numpy as np
import pytest
import torch

from dmesh_renderer_tpu_torch import TetRenderSettings, TetRenderer
from dmesh_renderer_tpu_torch.convert import tet_args_from_numpy
from dmesh_renderer_tpu_torch.ops import binning as tb
from dmesh_renderer_tpu_torch.ops import geometry as tg
from dmesh_renderer_tpu_torch.ops import rays as tr
from dmesh_renderer_tpu_torch.ops import tet as pt
from dmesh_renderer_tpu_torch.ops import tet_first_hit as pfh
from dmesh_renderer_tpu_torch.utils.connectivity import (
    build_tet_connectivity, freudenthal_grid,
)
import scenes

pytestmark = pytest.mark.gpu

# (grid n, jitter, grid seed, views, ring radius, H, W, ray seed): the
# adversarial golden's scene, an image that is no multiple of 16, and
# cameras outside the mesh without jitter
CASES = {
    "adversarial": (6, 0.14, 21, 2, 1.1, 48, 48, 17),
    "odd_37x50": (4, 0.12, 3, 1, 0.9, 37, 50, 5),
    "outside": (5, 0.1, 8, 2, 3.0, 64, 64, 0),
}
# and for K3 a ragged image whose tile lists (180-1,482 slots) are walked
# for a few of its 32-slot rounds, pixels stopping at a round's first slot
# and inside rounds
K3_CASES = {**CASES, "ragged_100x72": (8, 0.1, 8, 2, 2.0, 100, 72, 0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(case):
    n, jit, gseed, b, radius, h, w, seed = K3_CASES[case]
    verts, tets = freudenthal_grid(n, jitter=jit, seed=gseed)
    faces, face_tets, tet_faces = build_tet_connectivity(tets)
    rng = np.random.RandomState(33)
    vcolor = rng.rand(verts.shape[0], 3).astype(np.float32)
    fopacity = rng.uniform(0.05, 0.95, faces.shape[0]).astype(np.float32)
    fopacity[rng.randint(0, faces.shape[0], faces.shape[0] // 10)] = 1.0
    fintense = rng.uniform(0.5, 1.0, (b, faces.shape[0])).astype(np.float32)
    mv, proj = scenes.ring_cameras(b, radius=radius)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    args = (verts, faces, vcolor, fopacity, mv_t, proj_t,
            np.linalg.inv(mv_t), np.linalg.inv(proj_t), fintense, tets,
            face_tets, tet_faces, bg)
    return args, h, w, seed


def _stages(t, h, w, seed):
    """The binned forward's stages on the device of ``t``: a dict of every
    intermediate (the sequence of ``ops.tet.render_tet_forward``)."""
    B = t[4].shape[0]
    gx, gy = (w + 31) // 32, (h + 31) // 32
    s = {}
    ndc, img = tg.project_verts(t[0], t[4], t[5], w, h)
    s["pre"] = tg.preprocess_faces(ndc, img, t[1], w, h, 32, 32)
    s["rd"] = tr.generate_rays(t[6], t[7], w, h, norm_eps_mode="tet",
                               jitter_seed=seed or None)[1]
    s["keys"] = tb.emit_and_sort(s["pre"], gx, gy, 1 << 20,
                                 sort_by="min_depth")
    cam_o = t[6][:, 3, :3].contiguous()
    s["table"] = pfh.build_first_hit_table(
        t[0], t[1], cam_o, s["pre"]["min_depth"],
        s["pre"]["max_depth"])[s["keys"].sigma]
    k = s["keys"]
    s["fh_inputs"] = (k.starts, k.ends, k.slot_face, s["table"], s["rd"], B,
                      h, w)
    s["fh"] = pfh.first_hit_plain(*s["fh_inputs"])
    s["march"] = pt.march_tables(t[0], t[1], t[9], t[11], t[10], t[2], t[3],
                                 t[8])
    M = B * h * w
    rd = s["rd"].reshape(M, 3)
    ff = s["fh"][0].reshape(M)
    s["first_tet"] = pt.start_tets(ff, rd, s["march"]["geo"],
                                   s["march"]["sign"], t[10], t[11])
    s["zw"] = pt.projective_zw(cam_o, s["rd"].reshape(B, h * w, 3), t[4],
                               t[5])
    tuv = torch.stack([x.reshape(M) for x in s["fh"][1:4]])
    m = s["march"]
    s["march_inputs"] = (rd, cam_o, s["zw"], ff, s["first_tet"], tuv,
                         m["tet_geo"], m["tet_nrm"], m["tet_ids"], m["shade"],
                         h, w)
    return s


@pytest.mark.parametrize("case", list(K3_CASES))
def test_first_hit_kernel_matches_plain(case, cuda):
    args, h, w, seed = _scene(case)
    t = tet_args_from_numpy(*args, device=cuda)
    s = _stages(t, h, w, seed)
    before = pfh.first_hit.launches
    got = pfh.first_hit(*s["fh_inputs"])
    torch.cuda.synchronize()
    assert pfh.first_hit.launches == before + 1
    want = s["fh"]
    assert torch.equal(got[0], want[0])
    assert int((got[0] >= 0).sum()) > 0
    for g, p in zip(got[1:4], want[1:4]):
        assert float((g - p).abs().max()) <= 1e-6
    assert torch.equal(got[4], want[4])


def test_first_hit_kernel_round_edges(cuda):
    """K3 bit-equal to its plain version (all five outputs) at B=2 on a
    ragged 100x72 image whose lists span many rounds: pixels that stop at
    a round's first slot and inside a round, blocks that stop staging
    early; with tile 0's list emptied, tile 1's one slot long, and the
    rays of view 1's tile 2 turned around, so that its pixels all miss and
    walk the whole list."""
    args, h, w, seed = _scene("ragged_100x72")
    s = _stages(tet_args_from_numpy(*args, device=cuda), h, w, seed)
    starts, ends, slot_face, table, rd, B, _h, _w = s["fh_inputs"]
    gy, gx = (h + 31) // 32, (w + 31) // 32
    ends = ends.clone()
    ends[0] = starts[0]
    ends[1] = starts[1] + 1
    rd = rd.clone()
    rd[1, :32, 64:] = -rd[1, :32, 64:]
    inputs = (starts, ends, slot_face, table, rd, B, h, w)
    got = pfh.first_hit(*inputs)
    torch.cuda.synchronize()
    *want, visits = pfh.first_hit_plain(*inputs, with_visits=True)
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    face, walked = want[0], want[4]
    count = (ends - starts).reshape(B, gy, gx)
    miss = gy * gx + 2  # view 1's tile 2
    assert h % 32 and w % 32 and B == 2
    assert int(walked[0, 0, 0]) == 0 and bool((face[0, :32, :32] == -1).all())
    assert int(walked[0, 0, 1]) == 1
    assert int(count.reshape(-1)[miss]) > 2 * pfh.ROUND
    assert bool((face[1, :32, 64:] == -1).all())
    assert int(walked.reshape(-1)[miss]) == int(count.reshape(-1)[miss])
    tile_count = count[:, :, :, None, None].expand(B, gy, gx, 32, 32) \
        .permute(0, 1, 3, 2, 4).reshape(B, gy * 32, gx * 32)[:, :h, :w]
    stopped = visits < tile_count
    assert int((stopped & (visits % pfh.ROUND == 0)).sum()) > 0
    assert int((stopped & (visits % pfh.ROUND != 0)).sum()) > 0
    assert int((stopped & (visits > 2 * pfh.ROUND)).sum()) > 0
    assert bool((walked < count).any())


@pytest.mark.parametrize("case", list(CASES))
def test_march_kernel_matches_plain(case, cuda):
    args, h, w, seed = _scene(case)
    t = tet_args_from_numpy(*args, device=cuda)
    s = _stages(t, h, w, seed)
    before = pt.fwd_march.launches
    gf, gi = pt.fwd_march(*s["march_inputs"])
    torch.cuda.synchronize()
    assert pt.fwd_march.launches == before + 1
    pf, pi = pt.fwd_march_plain(*s["march_inputs"])
    assert torch.equal(gi, pi)
    assert int(gi[3].sum()) > 0 and int(gi[2].max()) > 1
    assert float((gf - pf).abs().max()) <= 1e-6


def _march_bit_equal(inputs, max_steps=pt.DEFAULT_MAX_MARCH_STEPS):
    got = pt.fwd_march(*inputs, max_steps)
    torch.cuda.synchronize()
    want = pt.fwd_march_plain(*inputs, max_steps)
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    return want


def test_march_kernel_bad_rays(cuda):
    """K4 against its plain version where walks break the march's
    invariants, at B=2: every 7th marching ray starts on a face of another
    tet (no slot of its tet is the entry face), every 13th flies the other
    way (its entry face does not oppose it). Each such walk ends after its
    first blend with the pixel inactive."""
    args, h, w, seed = _scene("adversarial")
    s = _stages(tet_args_from_numpy(*args, device=cuda), h, w, seed)
    inputs = list(s["march_inputs"])
    ff, ft = inputs[3].clone(), inputs[4]
    marching = torch.nonzero((ff >= 0) & (ft >= 0)).squeeze(1)
    lost = marching[::7]
    flipped = marching[3::13]
    n_faces = args[1].shape[0]
    ff[lost] = (ff[lost] + n_faces // 2) % n_faces
    rd = inputs[0].clone()
    rd[flipped] = -rd[flipped]
    inputs[0], inputs[3] = rd, ff
    _f, i_out = _march_bit_equal(inputs)
    broken = torch.cat([lost, flipped])
    assert int((i_out[3, broken] == 0).sum()) > broken.numel() // 2
    assert bool((i_out[2, broken] >= 1).all())


@pytest.mark.parametrize("max_steps", [1, 3])
def test_march_kernel_cut_walks(max_steps, cuda):
    """K4 against its plain version with ``max_steps`` below the longest
    walk: a cut walk blends ``max_steps`` faces and stays inactive."""
    args, h, w, seed = _scene("adversarial")
    s = _stages(tet_args_from_numpy(*args, device=cuda), h, w, seed)
    _f, i_out = _march_bit_equal(s["march_inputs"], max_steps)
    cut = (i_out[2] == max_steps) & (i_out[3] == 0)
    assert int(i_out[2].max()) == max_steps and int(cut.sum()) > 0


@pytest.mark.parametrize("case", ["adversarial", "outside"])
def test_stages_match_cpu(case, cuda):
    """Every stage without a transcendental is bit-equal on the card and on
    the CPU: rays (jittered or not), binning, the first hit (K3 on the card,
    its plain version on the CPU), the march tables but their log column,
    the start tets and the projective depth rows."""
    args, h, w, seed = _scene(case)
    sg = _stages(tet_args_from_numpy(*args, device=cuda), h, w, seed)
    sc = _stages(tet_args_from_numpy(*args, device="cpu"), h, w, seed)
    eq = lambda a, b, what: _assert_equal(a, b, f"{case}: {what}")
    eq(sg["rd"], sc["rd"], "rays")
    for k in ("starts", "ends", "slot_face", "sigma", "total"):
        eq(getattr(sg["keys"], k), getattr(sc["keys"], k), k)
    eq(sg["table"], sc["table"], "first-hit table")
    for i, g in enumerate(pfh.first_hit(*sg["fh_inputs"])):
        eq(g, sc["fh"][i], f"first hit output {i}")
    for k in ("tet_geo", "tet_ids", "geo", "sign"):
        eq(sg["march"][k], sc["march"][k], k)
    cols = [c for c in range(12) if c != 10]
    eq(sg["march"]["shade"][:, cols], sc["march"]["shade"][:, cols], "shade")
    eq(sg["first_tet"], sc["first_tet"], "start tets")
    eq(sg["zw"], sc["zw"], "projective z/w")


def _assert_equal(a, b, what):
    a = a.cpu() if isinstance(a, torch.Tensor) else a
    b = b.cpu() if isinstance(b, torch.Tensor) else b
    assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), what


@pytest.mark.parametrize("case", list(CASES))
def test_render_on_card_matches_cpu(case, cuda, monkeypatch):
    """End to end through ``TetRenderer`` (the binned first hit forced on
    these small scenes): the active mask and the saved integer state exact,
    colour and depth close (the card's and the CPU's exp differ in the last
    bits)."""
    args, h, w, seed = _scene(case)
    monkeypatch.setattr(pt, "BINNED_FIRST_HIT_THRESHOLD", 1)
    user = (args[0], args[1], args[2], args[3], np.swapaxes(args[4], 1, 2),
            np.swapaxes(args[5], 1, 2),
            np.zeros((args[4].shape[0], args[0].shape[0]), np.float32),
            args[8], args[9], args[10], args[11])
    settings = TetRenderSettings(h, w, args[12], ray_random_seed=seed)
    before = (pfh.first_hit.launches, pt.fwd_march.launches)
    cg, dg, ag, auxg = TetRenderer(settings, device="cuda")(
        *user, return_aux=True)
    torch.cuda.synchronize()
    assert (pfh.first_hit.launches, pt.fwd_march.launches) == (
        before[0] + 1, before[1] + 1)
    cc, dc, ac, auxc = TetRenderer(settings, device="cpu")(
        *user, return_aux=True)
    assert torch.equal(ag.cpu(), ac) and int(ac.sum()) > 0
    assert [int(x) for x in auxg] == [int(x) for x in auxc]
    assert float((cg.cpu() - cc).abs().max()) <= 1e-5
    assert float((dg.cpu() - dc).abs().max()) <= 1e-5
