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
from dmesh_renderer_tpu_torch.api import _inverses
from dmesh_renderer_tpu_torch.convert import tet_args_from_numpy
from dmesh_renderer_tpu_torch.ops import tet as pt
from dmesh_renderer_tpu_torch.ops import tet_first_hit as pfh
from dmesh_renderer_tpu_torch.tools import tet_stages
import scenes

pytestmark = pytest.mark.gpu

# the scenes of ``tools.tet_stages.CASES``: the adversarial golden's, an
# image that is no multiple of 16 and cameras outside the mesh; and for K3
# a ragged image whose tile lists are walked for a few 32-slot rounds
K3_CASES = tet_stages.CASES
CASES = {k: v for k, v in K3_CASES.items() if k != "ragged_100x72"}
_scene = tet_stages.scene


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stages(t, h, w, seed):
    """The binned forward's stages on the device of ``t`` up to K4's
    inputs, the first hit by its plain version: a dict of every
    intermediate, with ``fh_inputs`` and ``march_inputs``."""
    seq, s, fh_inputs, march_inputs = tet_stages.stages(t, h, w, seed,
                                                        kcap=1 << 20)
    for _name, fn in seq[:4]:  # projection, binning, table, rays
        fn()
    s["fh_inputs"] = fh_inputs()
    s["fh"] = pfh.first_hit_plain(*s["fh_inputs"])
    dict(seq)["march tables+start tet"]()
    s["march_inputs"] = march_inputs()
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


@pytest.mark.parametrize("case", list(K3_CASES))
def test_stages_match_cpu(case, cuda):
    """Every stage without a transcendental is bit-equal on the card and on
    the CPU: projection, binning, the first-hit table, rays (jittered or
    not), the first hit (K3 on the card, its plain version on the CPU), the
    march tables but their log column, the start tets, the projective
    depth rows and K4's integer outputs. Only the log column and what K4
    and the assembly derive from it through exp may differ."""
    args, h, w, seed = _scene(case)
    _first, differing = tet_stages.card_vs_cpu(cuda, args, h, w, seed)
    assert not tet_stages.not_transcendental(differing), (case, differing)


def test_inverses_bit_equal_on_card(cuda):
    """The API's inverses (``ops.geometry.inverse44``) are the same bits on
    the card and on the CPU: the cameras of every scene above, of the tet
    headline's ring, and random matrices."""
    mats = [np.concatenate([_scene(c)[0][4], _scene(c)[0][5]])
            for c in K3_CASES]
    mv, proj = scenes.ring_cameras(8)
    mats += [np.swapaxes(mv, 1, 2), np.swapaxes(proj, 1, 2),
             np.random.RandomState(7).randn(256, 4, 4)]
    m = torch.from_numpy(np.concatenate(mats).astype(np.float32))
    mv_c, proj_c = _inverses(m, m)
    mv_g, proj_g = _inverses(m.to(cuda), m.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(mv_g.cpu(), mv_c) and torch.equal(proj_g.cpu(), proj_c)
    assert bool(torch.isfinite(mv_c).all())


@pytest.mark.parametrize("case", list(K3_CASES))
def test_render_on_card_matches_cpu(case, cuda):
    """End to end through ``TetRenderer`` (the binned first hit forced on
    these small scenes): the active mask and the first hit's aux exact,
    colour and depth close (the card's and the CPU's log and exp differ in
    the last bits); then the forward with the API's inverses on each
    device, its saved integer state exact."""
    args, h, w, seed = _scene(case)
    user = (args[0], args[1], args[2], args[3], np.swapaxes(args[4], 1, 2),
            np.swapaxes(args[5], 1, 2),
            np.zeros((args[4].shape[0], args[0].shape[0]), np.float32),
            args[8], args[9], args[10], args[11])
    settings = TetRenderSettings(h, w, args[12], ray_random_seed=seed)
    before = (pfh.first_hit.launches, pt.fwd_march.launches)
    with pt.first_hit_path("binned"):
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
    saved = {}
    for dev in (cuda, torch.device("cpu")):
        t = list(tet_args_from_numpy(*args, device=dev))
        t[6], t[7] = _inverses(t[4], t[5])
        with pt.first_hit_path("binned"):
            saved[dev.type] = pt.render_tet_forward(*t, h, w, seed)[3]
    for k in ("first_face", "last_face", "last_tet", "n_contrib",
              "is_active"):
        assert torch.equal(saved["cuda"][k].cpu(), saved["cpu"][k]), k
