"""The torch port's tet backward on the card: K5 (``bwd_march``) against its
plain version, the start state against the CPU's, and the gradients end to
end.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX, so it runs where only PyTorch is installed:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_tet_bwd.py
"""

import numpy as np
import pytest
import torch

from dmesh_renderer_tpu_torch import TetRenderSettings, TetRenderer
from dmesh_renderer_tpu_torch.convert import tet_args_from_numpy
from dmesh_renderer_tpu_torch.ops import reduce as rd
from dmesh_renderer_tpu_torch.ops import tet as pt
from test_torch_gpu_tet import CASES, _scene

pytestmark = pytest.mark.gpu

# the card's gradients against the CPU port's, rel Linf: the two devices'
# exp and log differ in the last bits (march tables' log(1 - alpha), the
# forward's and backward's exp), hazard (g)
CARD_CPU_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def binned_first_hit():
    with pt.first_hit_path("binned"):
        yield


def _upstream(B, h, w, dev):
    rng = np.random.RandomState(5)
    return (torch.from_numpy(rng.randn(B, 3, h, w).astype(np.float32))
            .to(dev),
            torch.from_numpy(rng.randn(B, 1, h, w).astype(np.float32))
            .to(dev))


def _bwd_inputs(t, h, w, seed, gc, gd):
    """The forward on the device of ``t`` (binned first hit), then the
    backward march's inputs."""
    _c, _d, _a, saved = pt.render_tet_forward(*t, h, w, seed, kcap=1 << 20)
    ray_i, ray_f, off, n, _total, _ovf = pt.bwd_start_state(saved, t[10], gc,
                                                            gd, t[12])
    m = saved["march"]
    return saved, (saved["ray_d"], saved["cam_o"], saved["zw"], ray_i, ray_f,
                   off, n, m["tet_geo"], m["tet_nrm"], m["tet_ids"],
                   m["shade"], h * w)


def _grads(t, h, w, seed, gc, gd):
    t = list(t)
    for i in (2, 3):
        t[i] = t[i].detach().clone().requires_grad_(True)
    c, d, _a = pt.render_tet_core(*t, h, w, seed)
    ((c * gc).sum() + (d * gd).sum()).backward()
    return t[2].grad, t[3].grad


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def _same_records(got, want, inputs):
    """K5's and its plain version's outputs bit for bit: the keys (F past
    the records) and the mismatch flags whole, the records on the rows the
    rays own (the card leaves the capacity's rows past them unwritten)."""
    live = int(inputs[3][3].long().sum())
    assert live < inputs[6]
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert torch.equal(got[1][:live], want[1][:live])


@pytest.mark.parametrize("case", ["adversarial", "outside", "odd_37x50"])
def test_bwd_march_kernel_matches_plain(case, cuda, binned_first_hit):
    """K5 against its plain version on the same CUDA inputs: keys, records
    (on the rows the rays own) and mismatch flags bit for bit, and the
    gradients reduced from each."""
    args, h, w, seed = _scene(case)
    t = tet_args_from_numpy(*args, device=cuda)
    gc, gd = _upstream(t[4].shape[0], h, w, cuda)
    _saved, inputs = _bwd_inputs(t, h, w, seed, gc, gd)
    before = pt.bwd_march.launches
    got = pt.bwd_march(*inputs)
    torch.cuda.synchronize()
    assert pt.bwd_march.launches == before + 1
    want = pt.bwd_march_plain(*inputs)
    _same_records(got, want, inputs)
    assert inputs[6] > 0 and int(got[2].sum()) == 0
    n_verts = t[0].shape[0]
    for a, b in zip(pt.reduce_tet_records(*got[:2], t[1], n_verts),
                    pt.reduce_tet_records(*want[:2], t[1], n_verts)):
        assert torch.equal(a, b)


def test_bwd_march_kernel_bad_rays(cuda, binned_first_hit):
    """K5 against its plain version where re-walks do not retrace the
    forward, at B=2: every 7th ray with records is given a first face it
    never meets, so it walks past the forward's first face, and every 11th
    ray with two or more records a start tet of -1, so its walk ends after
    one visit and its other slots take the absorber key F and zeros. Each
    such ray's mismatch flag is set."""
    args, h, w, seed = _scene("adversarial")
    t = tet_args_from_numpy(*args, device=cuda)
    gc, gd = _upstream(t[4].shape[0], h, w, cuda)
    _saved, inputs = _bwd_inputs(t, h, w, seed, gc, gd)
    ray_i = inputs[3].clone()
    lost = torch.nonzero(ray_i[3] > 0).squeeze(1)[::7]
    cut = torch.nonzero(ray_i[3] > 1).squeeze(1)[3::11]
    ray_i[2, lost] = -5
    ray_i[1, cut] = -1
    inputs = inputs[:3] + (ray_i,) + inputs[4:]
    got = pt.bwd_march(*inputs)
    torch.cuda.synchronize()
    want = pt.bwd_march_plain(*inputs)
    _same_records(got, want, inputs)
    bad = torch.zeros_like(got[2])
    bad[lost], bad[cut] = 1, 1
    assert torch.equal(got[2], bad)
    F = t[1].shape[0]
    n_abs = int((ray_i[3, cut] - 1).sum())
    live = int(ray_i[3].sum())  # the rows past them keep the key F
    assert int((got[0][:live] == F).sum()) == n_abs > 0


@pytest.mark.parametrize("case", ["adversarial", "outside"])
def test_start_state_matches_cpu(case, cuda, binned_first_hit):
    """``bwd_start_state`` fed the same forward state on both devices: the
    same bits, but for the two exp rows (final T and final prev T), which
    the two devices' exp may round apart by an ulp."""
    args, h, w, seed = _scene(case)
    t = tet_args_from_numpy(*args, device="cpu")
    gc, gd = _upstream(t[4].shape[0], h, w, "cpu")
    _c, _d, _a, saved = pt.render_tet_forward(*t, h, w, seed)
    cpu = pt.bwd_start_state(saved, t[10], gc, gd, t[12])
    to = lambda x: x.to(cuda) if isinstance(x, torch.Tensor) else x
    saved_g = {k: to(v) for k, v in saved.items() if k != "march"}
    saved_g["march"] = {k: to(v) for k, v in saved["march"].items()}
    card = pt.bwd_start_state(saved_g, to(t[10]), to(gc), to(gd), to(t[12]))
    assert torch.equal(card[0].cpu(), cpu[0])
    assert torch.equal(card[1][:9].cpu(), cpu[1][:9])
    np.testing.assert_allclose(card[1][9:].cpu().numpy(),
                               cpu[1][9:].numpy(), rtol=2.4e-7, atol=0)
    assert torch.equal(card[2].cpu(), cpu[2]) and card[3] == cpu[3]
    assert torch.equal(card[4].cpu(), cpu[4]) and not bool(card[5])


def test_grads_deterministic_and_match_cpu(cuda, binned_first_hit):
    """Two backwards on the card give the same bits; the card's gradients
    are within ``CARD_CPU_RTOL`` of the port's on the CPU."""
    args, h, w, seed = _scene("adversarial")
    tg = tet_args_from_numpy(*args, device=cuda)
    tc = tet_args_from_numpy(*args, device="cpu")
    gc, gd = _upstream(tg[4].shape[0], h, w, cuda)
    before = (pt.bwd_march.launches, rd.seg_sum.launches)
    g1 = _grads(tg, h, w, seed, gc, gd)
    torch.cuda.synchronize()
    assert (pt.bwd_march.launches, rd.seg_sum.launches) == (
        before[0] + 1, before[1] + 2)
    g2 = _grads(tg, h, w, seed, gc, gd)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b) and bool(a.any())
    gcpu = _grads(tc, h, w, seed, gc.cpu(), gd.cpu())
    for a, b in zip(g1, gcpu):
        assert _rel(a, b) <= CARD_CPU_RTOL


def test_tetrenderer_grads_on_card(cuda):
    """The module path on the card: gradients for verts_color and
    faces_opacity, zeros for verts, the serving path launches no K5."""
    args, h, w, seed = _scene("outside")
    user = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in (
        args[0], args[1], args[2], args[3], np.swapaxes(args[4], 1, 2),
        np.swapaxes(args[5], 1, 2),
        np.zeros((args[4].shape[0], args[0].shape[0]), np.float32), args[8],
        args[9], args[10], args[11])]
    r = TetRenderer(TetRenderSettings(h, w, args[12], ray_random_seed=seed),
                    device="cuda")
    before = pt.bwd_march.launches
    r(*user)
    assert pt.bwd_march.launches == before
    for i in (0, 2, 3):
        user[i] = user[i].clone().requires_grad_(True)
    c, d, _a = r(*user)
    (c.sum() + d.sum()).backward()
    torch.cuda.synchronize()
    assert pt.bwd_march.launches == before + 1
    assert not bool(user[0].grad.any())
    assert bool(user[2].grad.any()) and bool(user[3].grad.any())
    assert bool(torch.isfinite(user[3].grad).all())
