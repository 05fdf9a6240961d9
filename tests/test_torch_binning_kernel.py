"""The tri binning's exact path: which route ``emit_and_sort`` takes, and
the card's launch path, on the CPU.

``emit_and_sort`` runs the plain torch body (``emit_exact_plain``) on CPU
tensors, with no launch, and the kernels of csrc/binning.cu on CUDA
tensors (``_exact_kernel``). The kernels' wrapper is driven here on CPU
tensors with ``kernels.launch`` on a pretend card: each of its three
launchers gets its tensors' pointers in the C signature's order (the
outputs of one launch are the inputs of the next), then the sizes; the
argument checks raise before any launch, and a launch that fails raises.
The kernels' outputs against the plain body, bit for bit, are held on the
card by ``tests/test_torch_gpu_binning.py``.
"""

import pytest
import torch

from dmesh_renderer_tpu_torch import kernels
from dmesh_renderer_tpu_torch.ops import binning as tb
from dmesh_renderer_tpu_torch.ops.geometry import (
    preprocess_faces, project_verts,
)
from dmesh_renderer_tpu_torch.utils.scenes import tri_scene

B, F, H, W, TILE = 2, 300, 64, 80, 32
GX, GY = 3, 2
KCAP = 8192


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: small tensors, beside the suite's parallel
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pre():
    """``preprocess_faces`` of a small scene of 300 triangles in 2 views at
    80x64 pixels (3x2 tiles)."""
    v, f, _vc, _fo, mv, proj, _vd, _fi = (
        torch.from_numpy(x) for x in tri_scene(F, B, H, W, seed=4))
    ndc, img = project_verts(v, mv.transpose(1, 2), proj.transpose(1, 2), W,
                             H)
    return preprocess_faces(ndc, img, f, W, H, TILE, TILE)


def _inputs(pre):
    """The exact path's inputs, in ``bin_count``'s order."""
    return [*(pre[k][e] for k in ("edge_a", "edge_b", "edge_c")
              for e in range(3)),
            pre["rect_min"], pre["rect_max"], pre["tiles"], pre["nondeg"]]


def test_plain_on_cpu(pre, monkeypatch):
    """CPU tensors take the plain body and launch nothing; the bbox path
    (no ``tile_px``) takes neither route."""
    want = tb.emit_exact_plain(pre, GX, GY, KCAP, TILE)
    assert int(want.total) > 0 and int(want.runs) > 0
    calls = []
    plain = tb.emit_exact_plain
    monkeypatch.setattr(tb, "emit_exact_plain", lambda *a: (
        calls.append(len(a)), plain(*a))[1])
    before = tb.emit_and_sort.launches
    got = tb.emit_and_sort(pre, GX, GY, KCAP, tile_px=TILE)
    for name, w, g in zip(want._fields, want, got):
        assert torch.equal(w, g), name
    tb.emit_and_sort(pre, GX, GY, KCAP, sort_by="min_depth")
    assert calls == [7]
    assert tb.emit_and_sort.launches == before


class _Launcher:
    """A stand-in for a launcher's ctypes function: records its arguments
    and returns ``err``."""

    def __init__(self, err=0):
        self.calls = []
        self.err = err

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def stub_card(monkeypatch):
    """``kernels.launch`` on a pretend card 0 with stream handle 77, and a
    stand-in for each launcher of csrc/binning.cu."""
    monkeypatch.setattr(kernels, "_current_device", lambda: 0)
    monkeypatch.setattr(kernels, "_raw_stream", lambda index: 77)
    fns = {fn: _Launcher() for fn in kernels.SIGNATURES["binning"]}
    for fn, f in fns.items():
        monkeypatch.setitem(kernels._fns, ("binning", fn), f)
    return fns


@pytest.mark.parametrize("run_cap", [None, 5000])
def test_launches(pre, stub_card, run_cap):
    """``bin_count`` gets the 13 inputs' and its 3 outputs' pointers, then
    B * F, the grid and the tile; ``bin_runs`` the presort's sigma, the
    scan of the emitted rows and ``bin_count``'s rows, then the run
    table's 4 columns (the counts zeroed); ``bin_emit`` the run table, the
    scan of its counts and the 2 slot columns, then the run table's and
    the slots' capacities, B, F and the grid; one counted call."""
    before = tb.emit_and_sort.launches
    keys = tb._exact_kernel(pre, GX, GY, KCAP, TILE, run_cap)
    assert tb.emit_and_sort.launches == before + 1
    (count,) = stub_card["bin_count"].calls
    (runs,) = stub_card["bin_runs"].calls
    (emit,) = stub_card["bin_emit"].calls
    for fn, call in (("bin_count", count), ("bin_runs", runs),
                     ("bin_emit", emit)):
        assert len(call) == len(kernels.SIGNATURES["binning"][fn]), fn
        assert call[-1] == 77
    n, nr_cap = B * F, tb.run_capacity(B * F, KCAP, run_cap)
    assert list(count[:13]) == [t.data_ptr() for t in _inputs(pre)]
    assert count[16:20] == (n, GX, GY, TILE)
    assert runs[0] == keys.sigma.data_ptr()
    assert runs[2] == count[15]  # bin_count's rows
    assert runs[7:12] == (n, nr_cap, GX, GY, TILE)
    assert emit[:4] == runs[3:7]  # the run table
    assert emit[7:13] == (nr_cap, KCAP, B, F, GX, GY)
    # the outputs and scans: 11 tensors, none shared
    assert len(set(count[13:16] + runs[1:2] + runs[3:7] + emit[4:7])) == 11


def test_launch_error_raises(pre, stub_card):
    """A launcher that returns a CUDA error raises, naming it."""
    stub_card["bin_count"].err = 700
    with pytest.raises(RuntimeError,
                       match="^bin_count launch failed: CUDA error 700$"):
        tb._exact_kernel(pre, GX, GY, KCAP, TILE)
    assert stub_card["bin_runs"].calls == []


@pytest.mark.parametrize("case_name,exc,msg", [
    ("edge i64", TypeError,
     "emit_and_sort: expected torch.int32, got torch.int64"),
    ("nondeg i32", TypeError,
     "emit_and_sort: expected torch.bool, got torch.int32"),
    ("rect shape", ValueError,
     r"emit_and_sort: expected shape \(2, 300, 2\), got \(2, 299, 2\)"),
    ("devices", ValueError, "emit_and_sort: all tensors must share a device"),
    ("strided", ValueError, "emit_and_sort: expected contiguous tensors"),
    ("keys", ValueError, "emit_and_sort: 600 \\(view, face\\) rows and "
     "2147483648 tile keys; the kernels index both in int32"),
])
def test_messages(pre, stub_card, case_name, exc, msg):
    """The wrapper's argument checks raise before any launch."""
    p = dict(pre)
    if case_name == "edge i64":
        p["edge_b"] = (p["edge_b"][0], p["edge_b"][1].long(), p["edge_b"][2])
    elif case_name == "nondeg i32":
        p["nondeg"] = p["nondeg"].int()
    elif case_name == "rect shape":
        p["rect_min"] = p["rect_min"][:, :-1]
    elif case_name == "devices":
        p["tiles"] = p["tiles"].to("meta")
    elif case_name == "strided":
        p["tiles"] = p["tiles"].t().contiguous().t()
    # "keys": a 2^15 x 2^15 grid, B * gx * gy = 2^31 tile keys
    gx, gy = (2 ** 15, 2 ** 15) if case_name == "keys" else (GX, GY)
    with pytest.raises(exc, match=f"^{msg}$"):
        tb._exact_kernel(p, gx, gy, KCAP, TILE)
    assert all(f.calls == [] for f in stub_card.values())
