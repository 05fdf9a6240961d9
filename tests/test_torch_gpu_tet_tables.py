"""The tet march tables and ray starts on the card: the kernels of
csrc/tet_tables.cu against the plain torch versions on the same card, bit
for bit.

``march_tables`` (kernel ``tet_tables``) against ``march_tables_plain``,
and ``ray_start`` (kernel ``tet_ray_start``) against ``start_tets_plain``,
``projective_zw_plain`` and the stacked t/u/v: on the benchmark's tet scene
(``freudenthal_grid(20, jitter 0.15)`` at 800x800) at two seeds with and
without jittered rays, on every scene of ``tools.tet_stages.CASES``, on
random first faces (misses, boundary faces, and tets of which both or
neither qualify) and on degenerate faces where the 1e-4 clamp of the
normal's length engages. Every float is compared by its bits. Then a
captured tet train step: both launch counters move once, at the capture,
and not in a replay.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_tet_tables.py
"""

import numpy as np
import pytest
import torch

from dmesh_renderer_tpu_torch.convert import tet_args_from_numpy
from dmesh_renderer_tpu_torch.models import dmesh
from dmesh_renderer_tpu_torch.ops import tet as pt
from dmesh_renderer_tpu_torch.tools import tet_stages
from dmesh_renderer_tpu_torch.utils.connectivity import (
    build_tet_connectivity, freudenthal_grid,
)
import scenes

pytestmark = pytest.mark.gpu

KEYS = ("tet_geo", "tet_nrm", "tet_ids", "shade", "geo", "sign")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    """Bit-equal: dtype, shape and every element's bits (-0.0 is not +0.0,
    a NaN equals the same NaN)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a), _bits(b)))


def grid20(seed):
    """The benchmark's tet scene at ``seed`` (NumPy arrays in
    ``render_tet_forward``'s order): ``freudenthal_grid(20, jitter 0.15)``,
    colours U[0, 1), opacities U(0.3, 0.9), intensities U(0.5, 1.0), one
    ring camera at radius 3, background 0.1."""
    verts, tets = freudenthal_grid(20, jitter=0.15, seed=seed)
    faces, face_tets, tet_faces = build_tet_connectivity(tets)
    rng = np.random.RandomState(seed)
    vcolor = rng.rand(verts.shape[0], 3).astype(np.float32)
    fopacity = rng.uniform(0.3, 0.9, faces.shape[0]).astype(np.float32)
    fintense = rng.uniform(0.5, 1.0, (1, faces.shape[0])).astype(np.float32)
    mv, proj = scenes.ring_cameras(1, radius=3.0)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    return (verts, faces, vcolor, fopacity, mv_t, proj_t,
            np.linalg.inv(mv_t), np.linalg.inv(proj_t), fintense, tets,
            face_tets, tet_faces, np.full(3, 0.1, np.float32))


def _first_hit(fargs, h, w, seed):
    """The stages of ``tools.tet_stages`` through K3 on the card: (stage
    dict, M)."""
    seq, st, _fh, _mi = tet_stages.stages(fargs, h, w, seed)
    for _name, fn in seq[:5]:
        fn()
    return st, fargs[4].shape[0] * h * w


def _tables_args(fargs):
    (verts, faces, vc, fo, _mv, _pj, _imv, _ipj, fi, tets, face_tets,
     tet_faces, _bg) = fargs
    return (verts, faces, tets, tet_faces, face_tets, vc, fo, fi)


def check_tables(fargs):
    """``march_tables`` on the card, one launch, against the plain version:
    every table bit for bit. Returns the kernel's tables."""
    args = _tables_args(fargs)
    before = pt.march_tables.launches
    got = pt.march_tables(*args)
    assert pt.march_tables.launches == before + 1
    want = pt.march_tables_plain(*args)
    assert list(got) == list(want)
    for k in KEYS:
        assert _same(got[k], want[k]), k
    return got


def check_ray_start(ff, rd, t, u, v, cam_o, mv_t, proj_t, geo, sign,
                    face_tets, tet_faces):
    """``ray_start`` (one launch) on the card against the plain versions,
    bit for bit. Returns the start tets."""
    M, B = rd.shape[0], cam_o.shape[0]
    want_ft = pt.start_tets_plain(ff, rd, geo, sign, face_tets, tet_faces)
    want_zw = pt.projective_zw_plain(cam_o, rd.reshape(B, M // B, 3), mv_t,
                                     proj_t)
    want_tuv = torch.stack([x.reshape(M) for x in (t, u, v)])
    before = pt.ray_start.launches
    ft, zw, tuv = pt.ray_start(ff, rd, t, u, v, cam_o, mv_t, proj_t, geo,
                               sign, face_tets, tet_faces)
    assert pt.ray_start.launches == before + 1
    assert _same(ft, want_ft) and _same(zw, want_zw) and _same(tuv, want_tuv)
    return ft


def check_scene(fargs, h, w, seed):
    st, M = _first_hit(fargs, h, w, seed)
    m = check_tables(fargs)
    cam_o = fargs[6][:, 3, :3].contiguous()
    ff = st["fh"][0].reshape(M)
    ft = check_ray_start(ff, st["rd"].reshape(M, 3), *st["fh"][1:4], cam_o,
                         fargs[4], fargs[5], m["geo"], m["sign"], fargs[10],
                         fargs[11])
    assert bool((ft >= 0).any())
    return ff


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("jitter", [0, 17])
def test_benchmark_scene(cuda, seed, jitter):
    """The benchmark's tet scene at 800x800, two seeds, rays with and
    without jitter."""
    fargs = tet_args_from_numpy(*grid20(seed), device=cuda)
    ff = check_scene(fargs, 800, 800, jitter)
    # rays that miss, and first faces on the boundary (the camera outside)
    assert bool((ff < 0).any())
    assert bool((fargs[10][ff[ff >= 0].long(), 1] < 0).any())


@pytest.mark.parametrize("case", list(tet_stages.CASES))
def test_stage_scenes(cuda, case):
    """The scenes of ``tools.tet_stages.CASES``: the adversarial golden's
    (opacities of exactly 1), an image that is no multiple of 16, cameras
    outside the mesh, and a ragged 100x72 image."""
    args, h, w, seed = tet_stages.scene(case)
    check_scene(tet_args_from_numpy(*args, device=cuda), h, w, seed)


def test_random_first_faces(cuda):
    """Random first faces (a quarter misses), directions and slot signs on
    the benchmark's mesh: misses, boundary faces, and first faces of which
    neither, one or both tets qualify (both: the second wins)."""
    fargs = tet_args_from_numpy(*grid20(1), device=cuda)
    m = pt.march_tables(*_tables_args(fargs))
    F, T = fargs[1].shape[0], fargs[9].shape[0]
    g = torch.Generator(device=cuda).manual_seed(5)
    M = 1 << 16
    ff = torch.randint(-F // 3, F, (M,), generator=g, device=cuda)
    ff = ff.clamp_min(-1).to(torch.int32)
    rd = torch.randn((M, 3), generator=g, device=cuda)
    sign = torch.where(torch.rand((T, 4), generator=g, device=cuda) < 0.5,
                       -1.0, 1.0)
    t, u, v = torch.rand((3, M), generator=g, device=cuda)
    cam_o = fargs[6][:, 3, :3].contiguous()
    face_tets, tet_faces = fargs[10], fargs[11]
    ft = check_ray_start(ff, rd, t, u, v, cam_o, fargs[4], fargs[5],
                         m["geo"], sign, face_tets, tet_faces)
    # each candidate's verdict, as start_tets_plain's rule decides it
    ffl = ff.long().clamp_min(0)
    ndot = (m["geo"][ffl, 9:12] * rd).sum(1)
    cands = face_tets.long()[ffl]
    ok = []
    for q in range(2):
        c = cands[:, q].clamp_min(0)
        s = (sign[c] * (tet_faces.long()[c] == ff.long()[:, None])).sum(1)
        ok.append((cands[:, q] >= 0) & (s * ndot < 0) & (ff >= 0))
    both = ok[0] & ok[1]
    assert bool(both.any()) and bool((ok[0] & ~ok[1]).any())
    assert bool((~ok[0] & ~ok[1] & (ff >= 0)).any())
    assert bool(((cands[:, 1] < 0) & (ff >= 0)).any())
    assert torch.equal(ft[both].long(), cands[both, 1])
    assert bool((ft[ff < 0] == -1).all())


def test_degenerate_faces(cuda):
    """Faces whose normal is shorter than 1e-4 (zero, and just below the
    clamp) take n / 1e-4, as the plain version does."""
    args, _h, _w, _seed = tet_stages.scene("adversarial")
    fargs = list(tet_args_from_numpy(*args, device=cuda))
    verts, faces = fargs[0].clone(), fargs[1].long()
    # face 0 collapses onto a line, face 1 shrinks to a sliver: a corner
    # moved onto, and next to, the midpoint of the other two
    for f, eps in ((0, 0.0), (1, 3e-5)):
        a, b, c = faces[f]
        verts[c] = (verts[a] + verts[b]) * 0.5 + eps
    fargs[0] = verts
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    short = torch.linalg.cross(e1, e2).norm(dim=1) < 1e-4
    assert int(short.sum()) >= 2
    m = check_tables(fargs)
    assert bool((m["geo"][short, 9:12].norm(dim=1) < 1).all())


def test_captured_step_launches_once(cuda):
    """A captured tet train step launches each kernel once per eager step
    and once at the capture; a replay launches neither (the graph holds
    them)."""
    arrs = tet_stages.scene("outside")[0]
    fargs = tet_args_from_numpy(*arrs, device=cuda)
    h = w = 64
    B = fargs[4].shape[0]
    geom = dmesh.TetGeometry(fargs[0], fargs[1], *fargs[9:12])
    batch = dmesh.TetViewBatch(*fargs[4:9], torch.rand(
        (B, 3, h, w), generator=torch.Generator().manual_seed(5)).to(cuda))
    scene = dmesh.TetScene(*(fargs[i].clone().requires_grad_(True)
                             for i in (2, 3)))
    st = dmesh.init_tet_train_state(scene, lambda p: torch.optim.Adam(
        p, lr=1e-2, capturable=True))
    step = dmesh.make_tet_train_step(geom, fargs[12], h, w)
    counts = []
    for _ in range(5):
        before = (pt.march_tables.launches, pt.ray_start.launches)
        st, loss = step(st, batch)
        torch.cuda.synchronize()
        counts.append((pt.march_tables.launches - before[0],
                       pt.ray_start.launches - before[1]))
        assert bool(torch.isfinite(loss))
    assert (step.captures, step.replays, step.fallbacks) == (1, 4, 0)
    # step 1 eager, step 2 captures (and replays), steps 3-5 replay
    assert counts == [(1, 1), (1, 1), (0, 0), (0, 0), (0, 0)]
