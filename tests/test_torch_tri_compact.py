"""The tri backward's compacted records and the lean kernel call path, on
the CPU.

``bwd_composite`` writes records only for each tile's walked prefix (the
slots up to its last contributor, ``walked_slots``), packed tile after
tile, with the slot id of each row. Every slot past a prefix would hold a
zero record, and the segment sums start at +0.0, so they never are -0.0
and adding +-0.0 changes nothing: the compacted records must reduce to the
bits of the full [S, 4, 22] layout, one row per slot. The plain version
with every slot walked (``_full_walk``) writes that layout, each record
at its slot as the kernel did before the compaction.

Both are sized at the static slot capacity S = ``slot_face.numel()`` (the
key capacity): the walked rows come first, and the rows past the walked
total carry the sentinel slot id S, which the reduce leaves out.

The JAX package is not run here: it compacts its records the same way
(``dmesh_renderer_tpu/ops/tri_binned.py::_reduce_records``), and
test_torch_tri_bwd.py holds the port's gradients to its ``jax.vjp``.
"""

import ctypes

import numpy as np
import pytest
import torch

from dmesh_renderer_tpu_torch import kernels
from dmesh_renderer_tpu_torch.convert import tri_inputs_from_numpy
from dmesh_renderer_tpu_torch.ops import reduce as trd
from dmesh_renderer_tpu_torch.ops import tri_binned as ttb
from dmesh_renderer_tpu_torch.tools import exp_round3 as ex
import scenes
from test_torch_geometry import scene

KCAP = 8192


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels run thousands of small torch ops; on one thread
    they do not spin against the threads of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cam(n_views, h, w, eye=None):
    if eye is None:
        mv, proj = scenes.ring_cameras(n_views, radius=3.0)
    else:
        mv = scenes.look_at(eye, [0, 0, 0], [0, 1, 0])[None]
        proj = scenes.perspective(45.0, w / h, 0.1, 10.0)[None]
    mv_t = np.swapaxes(mv, 1, 2).astype(np.float32).copy()
    proj_t = np.swapaxes(proj, 1, 2).astype(np.float32).copy()
    return mv_t, proj_t


def _inputs(verts, faces, colors, opacity, mv_t, proj_t, seed):
    rng = np.random.RandomState(seed)
    B, P, F = mv_t.shape[0], verts.shape[0], faces.shape[0]
    vd = rng.uniform(-1, 1, (B, P)).astype(np.float32)
    fi = rng.uniform(0.5, 1.0, (B, F)).astype(np.float32)
    return tri_inputs_from_numpy(
        verts, faces, colors, opacity, mv_t, proj_t, np.linalg.inv(mv_t),
        np.linalg.inv(proj_t), vd, fi, np.array([0.2, 0.3, 0.1], np.float32),
        device="cpu")


def _empty_tiles():
    """Six small triangles in the middle of a 136x104 frame: most tiles
    hold no face, and the frame is no multiple of 32 (padded quarters)."""
    soup = scenes.random_triangle_soup(6, seed=3, spread=0.25)
    h, w = 136, 104
    mv_t, proj_t = _cam(1, h, w)
    return _inputs(soup["verts"], soup["faces"], soup["verts_color"],
                   soup["faces_opacity"], mv_t, proj_t, 4), h, w


def _stack(opacity):
    """Eight large triangles, each over the whole 40x72 frame. Faint ones
    (0.1): every pixel blends its whole list (T stays above 0.9^8), so the
    walked count equals the list length and compaction shrinks nothing.
    Near-opaque ones (0.995): every pixel is done after two, so each tile
    walks two of its eight slots."""
    n, h, w = 8, 40, 72
    tri = np.array([[-3, -3, 0], [9, -3, 0], [-3, 9, 0]], np.float32)
    verts = np.concatenate([tri + [0, 0, -0.3 * k] for k in range(n)])
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    rng = np.random.RandomState(5)
    colors = rng.uniform(0, 1, (3 * n, 3)).astype(np.float32)
    mv_t, proj_t = _cam(1, h, w, eye=[0.0, 0.0, 3.0])
    return _inputs(verts, faces, colors, np.full(n, opacity, np.float32),
                   mv_t, proj_t, 6), h, w


def _scene(name):
    if name == "empty_tiles":
        return _empty_tiles()
    if name.endswith("stack"):
        return _stack(0.1 if name == "whole_stack" else 0.995)
    _a, t, h, w = scene(name)
    return t, h, w


def _full_walk(starts, ends, _n_contrib, _B, _H, _W):
    """``walked_slots`` with every slot walked: the tile ranges cover the
    slots in order, so each record row is its slot (the full layout)."""
    assert int(starts[0]) == 0 and torch.equal(starts[1:], ends[:-1])
    return torch.cat([starts, ends[-1:]]), ends[-1]


def _walked_numpy(starts, ends, nc, B, H, W):
    """Per tile min(list length, the largest n_contrib of its pixels)."""
    gy, gx = -(-H // 32), -(-W // 32)
    nc = nc.numpy()
    out = []
    for b in range(B):
        for ty in range(gy):
            for tx in range(gx):
                m = nc[b, ty * 32:(ty + 1) * 32, tx * 32:(tx + 1) * 32].max()
                t = (b * gy + ty) * gx + tx
                out.append(min(int(ends[t] - starts[t]), int(m)))
    return np.array(out)


@pytest.mark.parametrize("name", ["binned_fixture", "golden", "adversarial",
                                  "empty_tiles", "whole_stack",
                                  "opaque_stack"])
def test_compact_records_reduce_as_full_layout(name):
    """The five gradients reduced from the compacted plain records and from
    the full layout (every slot a row, zeros past the walks) are bitwise
    equal; the rows are the tiles' walked prefixes in order, at the
    static slot capacity, the rows past them zero with the sentinel id."""
    t, h, w = _scene(name)
    _c, _d, keys, inputs, state = ttb._forward(*t, h, w, KCAP, None)
    B = inputs[6]
    g = torch.Generator().manual_seed(7)
    gin = torch.randn((B, 5, h, w), generator=g)
    rec, slot_ids = ttb.bwd_composite_plain(*inputs[:6], *state, gin,
                                            *inputs[6:])
    S = keys.slot_face.numel()
    starts, ends = keys.starts, keys.ends
    n_live = int(ends[-1])
    walked = _walked_numpy(starts, ends, state[2], B, h, w)
    wk = int(walked.sum())
    assert S == KCAP and rec.shape == (S, 4, ttb.REC_COLS)
    assert slot_ids.dtype == torch.int32
    assert slot_ids[:wk].tolist() == [int(starts[i]) + p
                                      for i in range(len(walked))
                                      for p in range(walked[i])]
    assert bool((slot_ids[wk:] == S).all()) and not bool(rec[wk:].any())
    assert bool(rec.any())
    if name == "empty_tiles":
        assert int((ends == starts).sum()) > len(walked) // 2
    if name == "whole_stack":
        assert wk == n_live == int((ends - starts).sum())
    if name == "opaque_stack":
        assert wk * 4 == n_live

    # the full layout: each compacted row at its slot, zeros elsewhere
    # (the slots past the live ones hold the sentinel face row)
    full = torch.zeros((S, 4, ttb.REC_COLS))
    full[slot_ids[:wk].long()] = rec[:wk]
    all_ids = torch.arange(S, dtype=torch.int32)

    args = (keys.slot_face, keys.sigma, inputs[3], t[1], t[9], t[0].shape[0])
    got = ttb.reduce_records(rec, slot_ids, *args)
    want = ttb.reduce_records(full, all_ids, *args)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("name", ["binned_fixture", "empty_tiles"])
def test_walked_slots(name, monkeypatch):
    """The prefix sums of the walked counts against a loop over the tiles;
    the wrapper on the CPU returns its plain version's two outputs; with
    every slot walked, the plain version writes the full layout: each
    compacted row at its slot and zeros at the slots past the walks. The
    total stays a tensor (no host read) and the records and slot ids have
    the static slot capacity."""
    t, h, w = _scene(name)
    _c, _d, keys, inputs, state = ttb._forward(*t, h, w, KCAP, None)
    B = inputs[6]
    offs, total = ttb.walked_slots(keys.starts, keys.ends, state[2], B, h, w)
    walked = _walked_numpy(keys.starts, keys.ends, state[2], B, h, w)
    assert offs.dtype == torch.int32 and isinstance(total, torch.Tensor)
    assert total.ndim == 0
    assert offs.tolist() == [0, *np.cumsum(walked).tolist()]
    assert int(total) == int(walked.sum())
    wk = int(total)
    gin = torch.ones((B, 5, h, w))
    rec, ids = ttb.bwd_composite(*inputs[:6], *state, gin, *inputs[6:])
    S = keys.slot_face.numel()
    assert rec.shape == (S, 4, ttb.REC_COLS) and ids.shape == (S,)
    n_live = int(keys.ends[-1])
    with monkeypatch.context() as m:
        m.setattr(ttb, "walked_slots", _full_walk)
        full, all_ids = ttb.bwd_composite_plain(*inputs[:6], *state, gin,
                                                *inputs[6:])
    assert full.shape == (S, 4, ttb.REC_COLS)
    assert torch.equal(all_ids[:n_live],
                       torch.arange(n_live, dtype=torch.int32))
    assert bool((all_ids[n_live:] == S).all())
    assert torch.equal(full[ids[:wk].long()], rec[:wk])
    rest = torch.ones(S, dtype=torch.bool)
    rest[ids[:wk].long()] = False
    assert not bool(full[rest].any())


class _Launcher:
    """A stand-in for a launcher's ctypes function: records its arguments
    and returns a fixed CUDA error code."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def stub_device(monkeypatch):
    """``kernels.launch`` on a pretend card 0 with stream handle 77."""
    monkeypatch.setattr(kernels, "_current_device", lambda: 0)
    monkeypatch.setattr(kernels, "_raw_stream", lambda index: 77)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("err", [0, 700])
def test_launch_passes_ints_and_raises_on_error(err, stub_device,
                                                monkeypatch):
    """The launcher gets each tensor's pointer and the stream as plain
    ints, then the scalars; a non-zero return raises with the launcher's
    name and the code."""
    fn = _Launcher(err)
    monkeypatch.setitem(kernels._fns, ("probes", "take_rows"), fn)
    a, b = torch.zeros(4), torch.ones(3, dtype=torch.int32)
    if err:
        with pytest.raises(RuntimeError,
                           match="take_rows launch failed: CUDA error 700"):
            kernels.launch("probes", "take_rows", [a, b], [5, 6],
                           stub_device)
    else:
        kernels.launch("probes", "take_rows", [a, b], [5, 6], stub_device)
    assert fn.calls == [(a.data_ptr(), b.data_ptr(), 5, 6, 77)]
    assert all(type(x) is int for x in fn.calls[0])


def test_launcher_resolved_once(monkeypatch):
    """``kernels.launcher`` loads a library and looks a launcher up once;
    later calls reuse the function."""
    loads = []

    class Lib:
        take_rows = _Launcher(0)

    def load(name):
        loads.append(name)
        return Lib

    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "_fns", {})
    f1 = kernels.launcher("probes", "take_rows")
    f2 = kernels.launcher("probes", "take_rows")
    assert f1 is f2 is Lib.take_rows and loads == ["probes"]
    # the signatures the launchers are typed with: K2 takes 13 pointers
    sig = kernels.SIGNATURES["tri_bwd"]["tri_bwd_composite"]
    assert sig.count(ctypes.c_void_p) == 14 and len(sig) == 17


@pytest.mark.parametrize("case,exc,msg", [
    ("tab f64", TypeError,
     "take_rows: expected torch.float32, got torch.float64"),
    ("idx i64", TypeError,
     "take_rows: expected torch.int32, got torch.int64"),
    ("tab shape", ValueError,
     r"take_rows: expected shape \(4, 128\), got \(4, 64\)"),
    ("empty", ValueError, "take_rows: empty table"),
    ("devices", ValueError, "take_rows: all tensors must share a device"),
])
def test_take_rows_messages(case, exc, msg):
    """T1's wrapper raises with the messages it always had."""
    tab = torch.zeros((4, 128))
    idx = torch.zeros((3, 128), dtype=torch.int32)
    if case == "tab f64":
        tab = tab.double()
    elif case == "idx i64":
        idx = idx.long()
    elif case == "tab shape":
        tab = torch.zeros((4, 64))
    elif case == "empty":
        tab = torch.zeros((0, 128))
    else:
        idx = idx.to("meta")
    with pytest.raises(exc, match=f"^{msg}$"):
        ex.take_rows(tab, idx)


@pytest.mark.parametrize("case,exc,msg", [
    ("values f64", TypeError,
     r"seg_sum: values must be a 2-D float32 tensor, got torch.float64 "
     r"\(6, 2\)"),
    ("values 1-D", TypeError,
     r"seg_sum: values must be a 2-D float32 tensor, got torch.float32 "
     r"\(12,\)"),
    ("order i64", TypeError, "seg_sum: order must be int32 and offsets int64"),
    ("rows", ValueError, "seg_sum: 6 ordered rows for 5 value rows"),
    ("devices", ValueError, "seg_sum: all tensors must share a device"),
])
def test_seg_sum_messages(case, exc, msg):
    """seg_sum's checks raise with the messages they always had."""
    csr = trd.segment_csr(torch.tensor([1, 0, 2, 1, 0, 2]), 3)
    vals = torch.ones((6, 2))
    if case == "values f64":
        vals = vals.double()
    elif case == "values 1-D":
        vals = torch.ones(12)
    elif case == "order i64":
        csr = trd.SegmentCSR(csr.order.long(), csr.offsets)
    elif case == "rows":
        vals = torch.ones((5, 2))
    else:
        csr = trd.SegmentCSR(csr.order.to("meta"), csr.offsets)
    with pytest.raises(exc, match=f"^{msg}$"):
        trd.seg_sum(vals, csr)
    assert torch.equal(trd.seg_sum(torch.ones((6, 2)),
                                   trd.segment_csr(
                                       torch.tensor([1, 0, 2, 1, 0, 2]), 3)),
                       torch.full((3, 2), 2.0))
