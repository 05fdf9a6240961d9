"""The experiment kernels T1-T4 on the card against their plain versions,
at small sizes, and the diagnostics' CUDA paths.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX, so it runs where only PyTorch is installed:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_probes.py
"""

import numpy as np
import pytest
import torch

from dmesh_renderer_tpu_torch.tools import exp_round3 as ex
from dmesh_renderer_tpu_torch.tools import proto_march_kernel as pm
from dmesh_renderer_tpu_torch.utils import diagnostics as dg

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("S", [8, 64, 96, 97, 512, 48_000])
@pytest.mark.parametrize("R", [1, 8, 33])
def test_take_rows_kernel_matches_plain(S, R, cuda):
    """Both routes (shared memory up to 96 rows, L2 above), ragged row
    counts, and clamped indices."""
    rng = np.random.RandomState(S + R)
    tab = torch.from_numpy(rng.rand(S, 128).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(
        rng.randint(-2, S + 2, (R, 128)).astype(np.int32)).to(cuda)
    before = ex.take_rows.launches
    got = ex.take_rows(tab, idx)
    torch.cuda.synchronize()
    assert ex.take_rows.launches == before + 1
    assert torch.equal(got, ex.take_rows_plain(tab, idx))


def test_take_rows_lean_call_path(cuda):
    """T1 through the lean call path: the launcher is resolved once, and
    the raw stream handle is the current stream's, so a call on a side
    stream runs there and is ordered with that stream's work."""
    from dmesh_renderer_tpu_torch import kernels

    rng = np.random.RandomState(5)
    tab = torch.from_numpy(rng.rand(48_000, 128).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(
        rng.randint(0, 48_000, (5_000, 128)).astype(np.int32)).to(cuda)
    want = ex.take_rows_plain(tab, idx)
    fn = kernels.launcher("probes", "take_rows")
    assert kernels.launcher("probes", "take_rows") is fn
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert kernels._raw_stream(cuda.index or 0) == side.cuda_stream
        tab2 = tab * 1.0  # work the kernel must follow on the side stream
        got = ex.take_rows(tab2, idx)
    side.synchronize()
    assert torch.equal(got, want)
    assert kernels._fns[("probes", "take_rows")] is fn


@pytest.mark.parametrize("G", [1, 32, 41])
def test_roll_merge_kernel_matches_plain(G, cuda):
    buf = ex.e3_buffer(G * 128)
    buf[:, 0, 60:70] = 7.0
    buf[0, 3, 0] = np.inf  # read through the wrap by lane 127: 0 * inf
    buf = buf.to(cuda)
    before = ex.roll_merge.launches
    got = ex.roll_merge(buf)
    torch.cuda.synchronize()
    assert ex.roll_merge.launches == before + 1
    want = ex.roll_merge_plain(buf)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert bool(got[0, 3, 127].isnan())


def test_t3_entries_match_plain(cuda):
    march, mega, ct, consts, state = ex.e5_inputs(cuda, n_grid=4, M=4096 + 37)
    tabs = (march["tet_geo"], march["tet_ids"], march["shade"])
    before = (ex.mega_step.launches, ex.two_table_step.launches)
    a = ex.mega_step(mega, ct, consts, state)
    b = ex.two_table_step(*tabs, ct, consts, state)
    torch.cuda.synchronize()
    assert (ex.mega_step.launches, ex.two_table_step.launches) == (
        before[0] + 1, before[1] + 1)
    want = ex.mega_step_plain(mega, ct, consts, state)
    assert torch.equal(a, want) and torch.equal(b, want)
    assert torch.equal(ex.two_table_step_plain(*tabs, ct, consts, state),
                       want)


@pytest.mark.parametrize("mesh", [False, True])
def test_proto_chain_matches_plain(mesh, cuda):
    """Two chained steps on the tool's random tables (every lane errs) and
    on a real mesh, where rays advance."""
    M = 4096 + 37
    tabs = (pm.mesh_tables(cuda, n_grid=4, M=M) if mesh
            else pm.random_tables(cuda, M=M, T=300, F=700))
    before = pm.proto_step.launches
    got = pm.chain(*tabs, steps=2)
    torch.cuda.synchronize()
    assert pm.proto_step.launches == before + 2
    want = pm.chain(*tabs, steps=2, step=pm.proto_step_plain)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert bool((got[0][11] == 0).any()) == mesh


def test_proto_step_misaligned_tables(cuda):
    """T4 on tables whose base is not 16-byte aligned (views at storage
    offset 1; the wrapper copies them, the kernel reads rows as float4),
    bit-equal to its plain version, on the random tables and on a mesh."""
    M = 4096 + 37
    for tabs in (pm.random_tables(cuda, M=M, T=300, F=700),
                 pm.mesh_tables(cuda, n_grid=4, M=M)):
        views = []
        for tab in tabs[:2]:
            base = torch.empty(tab.numel() + 1, device=cuda)
            view = base[1:].view(tab.shape)
            view.copy_(tab)
            assert view.data_ptr() % 16
            views.append(view)
        args = (*views, *tabs[2:])
        before = pm.proto_step.launches
        got = pm.proto_step(*args)
        torch.cuda.synchronize()
        assert pm.proto_step.launches == before + 1
        assert torch.equal(got, pm.proto_step_plain(*tabs))


def test_diagnostics_on_card(cuda, tmp_path):
    t = dg.StageTimer()
    with t.stage("mm"):
        x = torch.randn(512, 512, device=cuda)
        x @ x
    assert t.times["mm"] > 0
    with dg.trace(str(tmp_path)) as prof:
        (x @ x).sum().item()
    assert dg.device_busy_ms(prof) > 0
    h = dg.tet_health(torch.ones((1, 4, 4), dtype=torch.bool, device=cuda))
    assert h["active_fraction"] == 1.0 and h["inactive_pixels"] == 0
