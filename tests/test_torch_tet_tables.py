"""The tet march tables and ray starts: which path each wrapper takes, and
the card's launch path, on the CPU.

``march_tables`` and ``ray_start`` run their plain torch versions on CPU
tensors (no launch) and the kernels of csrc/tet_tables.cu on CUDA tensors. The kernels' wrappers are driven here
on CPU tensors with ``kernels.launch`` on a pretend card: the launcher
gets every tensor's pointer in its C signature's order, then the sizes,
and the argument checks raise before any launch. The kernels' outputs
against the plain versions, bit for bit, are held on the card by
``tests/test_torch_gpu_tet_tables.py``.
"""

import pytest
import torch

from dmesh_renderer_tpu_torch import kernels
from dmesh_renderer_tpu_torch.convert import tet_args_from_numpy
from dmesh_renderer_tpu_torch.ops import tet as pt
from dmesh_renderer_tpu_torch.tools import tet_stages

H, W = 6, 5


@pytest.fixture(scope="module")
def case():
    """``tet_stages``' odd scene at 6x5 through K3 on the CPU, and its
    march tables: (fargs, stage dict, M)."""
    args, _h, _w, _seed = tet_stages.scene("odd_37x50")
    fargs = tet_args_from_numpy(*args, device="cpu")
    seq, st, _fh, _mi = tet_stages.stages(fargs, H, W)
    for _name, fn in seq[:6]:  # up to the march tables and start tets
        fn()
    return fargs, st, fargs[4].shape[0] * H * W


def _tables_args(fargs):
    (verts, faces, vc, fo, _mv, _pj, _imv, _ipj, fi, tets, face_tets,
     tet_faces, _bg) = fargs
    return [verts, faces, tets, tet_faces, face_tets, vc, fo, fi]


def _ray_args(fargs, st, M):
    """ray_start's arguments, in its order."""
    cam_o = fargs[6][:, 3, :3].contiguous()
    return [st["ff"], st["rd"].reshape(M, 3),
            *[x.reshape(M) for x in st["fh"][1:4]], cam_o,
            fargs[4], fargs[5], st["march"]["geo"], st["march"]["sign"],
            fargs[10], fargs[11]]


def test_plain_on_cpu(case, monkeypatch):
    """CPU tensors take the plain versions and launch nothing; ray_start
    gives start_tets_plain's, projective_zw_plain's and the stacked t/u/v's
    bits."""
    fargs, st, M = case
    ra = _ray_args(fargs, st, M)
    B = fargs[4].shape[0]
    want = (pt.march_tables_plain(*_tables_args(fargs)),
            pt.start_tets_plain(ra[0], ra[1], *ra[8:]),
            pt.projective_zw_plain(ra[5], ra[1].reshape(B, M // B, 3),
                                   ra[6], ra[7]),
            torch.stack(ra[2:5]))
    calls = []
    for name in ("march_tables_plain", "start_tets_plain",
                 "projective_zw_plain"):
        fn = getattr(pt, name)
        monkeypatch.setattr(pt, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    before = (pt.march_tables.launches, pt.ray_start.launches)
    m = pt.march_tables(*_tables_args(fargs))
    assert list(m) == list(want[0])
    for k, v in want[0].items():
        assert torch.equal(m[k], v), k
    first_tet, zw, tuv = pt.ray_start(*ra)
    assert torch.equal(first_tet, want[1])
    assert torch.equal(zw, want[2])
    assert torch.equal(tuv, want[3])
    assert first_tet.dtype == torch.int32 and bool((first_tet >= 0).any())
    assert calls == ["march_tables_plain", "start_tets_plain",
                     "projective_zw_plain"]
    assert (pt.march_tables.launches, pt.ray_start.launches) == before


class _Launcher:
    """A stand-in for a launcher's ctypes function: records its
    arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub_card(monkeypatch):
    """``kernels.launch`` on a pretend card 0 with stream handle 77, and a
    stand-in for each launcher of csrc/tet_tables.cu."""
    monkeypatch.setattr(kernels, "_current_device", lambda: 0)
    monkeypatch.setattr(kernels, "_raw_stream", lambda index: 77)
    fns = {fn: _Launcher() for fn in ("tet_tables", "tet_ray_start")}
    for fn, f in fns.items():
        monkeypatch.setitem(kernels._fns, ("tet_tables", fn), f)
    return fns


def test_tables_launch(case, stub_card):
    """``tet_tables`` gets the 8 inputs' and 6 outputs' pointers, then F,
    T, B and the stream; one launch, counted."""
    fargs, _st, _M = case
    args = _tables_args(fargs)
    F, T, B = fargs[1].shape[0], fargs[9].shape[0], fargs[4].shape[0]
    before = pt.march_tables.launches
    out = pt._tables_kernel(*args)
    assert pt.march_tables.launches == before + 1
    shapes = {"tet_geo": (T, 40), "tet_nrm": (T, 12), "tet_ids": (T, 8),
              "shade": (B * F, 12), "geo": (F, 12), "sign": (T, 4)}
    assert {k: tuple(v.shape) for k, v in out.items()} == shapes
    assert list(out) == list(shapes)  # march_tables_plain's key order
    assert out["tet_ids"].dtype == torch.int32
    (call,) = stub_card["tet_tables"].calls
    outs = [out[k] for k in ("geo", "sign", "tet_geo", "tet_nrm", "tet_ids",
                             "shade")]
    assert call == (*[t.data_ptr() for t in args + outs], F, T, B, 77)
    assert len(call) == len(kernels.SIGNATURES["tet_tables"]["tet_tables"])


@pytest.mark.parametrize("aligned", [True, False])
def test_ray_start_launch(case, stub_card, aligned):
    """``tet_ray_start`` gets its 12 inputs' and 3 outputs' pointers, then
    M and N; one launch, counted. A ``geo``, ``sign`` or ``tet_faces`` not
    16-byte aligned (and a ``face_tets`` not 8-byte aligned) goes as an
    aligned copy."""
    fargs, st, M = case
    a = _ray_args(fargs, st, M)
    if not aligned:
        # each table a view 4 bytes into a larger buffer
        for i in (8, 9, 10, 11):
            x = a[i]
            a[i] = torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:].view(
                x.shape)
            assert a[i].data_ptr() % 8 == 4 and torch.equal(a[i], x)
    before = pt.ray_start.launches
    out = pt._ray_start_kernel(*a)
    assert pt.ray_start.launches == before + 1
    assert [tuple(x.shape) for x in out] == [(M,), (M, 4), (3, M)]
    assert [x.dtype for x in out] == [torch.int32] + [torch.float32] * 2
    (call,) = stub_card["tet_ray_start"].calls
    ptrs = [x.data_ptr() for x in a + list(out)]
    B = fargs[4].shape[0]
    if aligned:
        assert call == (*ptrs, M, M // B, 77)
    else:
        moved = (8, 9, 10, 11)
        assert [call[i] for i in range(15) if i not in moved] == [
            p for i, p in enumerate(ptrs) if i not in moved]
        assert all(call[i] != ptrs[i] for i in moved)
        assert all(call[i] % 16 == 0 for i in (8, 9, 11))
        assert call[10] % 8 == 0 and call[15:] == (M, M // B, 77)
    assert len(call) == len(
        kernels.SIGNATURES["tet_tables"]["tet_ray_start"])


@pytest.mark.parametrize("case_name,exc,msg", [
    ("faces i64", TypeError,
     "march_tables: expected torch.int32, got torch.int64"),
    ("verts f64", TypeError,
     "march_tables: expected torch.float32, got torch.float64"),
    ("intense shape", ValueError,
     r"march_tables: expected shape \(1, 864\), got \(1, 863\)"),
    ("devices", ValueError, "march_tables: all tensors must share a device"),
    ("unsupported", ValueError, "march_tables: unsupported device meta"),
])
def test_tables_messages(case, stub_card, case_name, exc, msg):
    """``tet_tables``' wrapper raises before any launch, in the style of
    ``fwd_march``'s checks."""
    fargs, _st, _M = case
    args = _tables_args(fargs)
    assert args[1].shape[0] == 864  # F of the scene
    if case_name == "faces i64":
        args[1] = args[1].long()
    elif case_name == "verts f64":
        args[0] = args[0].double()
    elif case_name == "intense shape":
        args[7] = args[7][:, :-1]
    elif case_name == "devices":
        args[6] = args[6].to("meta")
    else:
        args = [x.to("meta") for x in args]
    fn = pt.march_tables if case_name == "unsupported" else pt._tables_kernel
    with pytest.raises(exc, match=f"^{msg}$"):
        fn(*args)
    assert stub_card["tet_tables"].calls == []


@pytest.mark.parametrize("case_name,exc,msg", [
    ("first_face i64", TypeError,
     "ray_start: expected torch.int32, got torch.int64"),
    ("face_tets shape", ValueError,
     r"ray_start: expected shape \(864, 2\), got \(864, 3\)"),
    ("mv_t shape", ValueError,
     r"ray_start: expected shape \(1, 4, 4\), got \(1, 3, 4\)"),
    ("t f64", TypeError,
     "ray_start: expected torch.float32, got torch.float64"),
    ("views", ValueError, "ray_start: 30 rays for 4 views"),
    ("unsupported", ValueError, "ray_start: unsupported device meta"),
])
def test_ray_start_messages(case, stub_card, case_name, exc, msg):
    """``tet_ray_start``'s wrapper raises before any launch."""
    fargs, st, M = case
    a = _ray_args(fargs, st, M)
    if case_name == "first_face i64":
        a[0] = a[0].long()
    elif case_name == "face_tets shape":
        a[10] = torch.zeros((864, 3), dtype=torch.int32)
    elif case_name == "mv_t shape":
        a[6] = a[6][:, :3]
    elif case_name == "t f64":
        a[2] = a[2].double()
    elif case_name == "views":
        a[5:8] = [x.expand(4, *x.shape[1:]) for x in a[5:8]]
    fn = pt._ray_start_kernel
    if case_name == "unsupported":
        a, fn = [x.to("meta") for x in a], pt.ray_start
    with pytest.raises(exc, match=f"^{msg}$"):
        fn(*a)
    assert stub_card["tet_ray_start"].calls == []
