"""The round-3 experiment battery, asked of one CUDA card.

A port of the JAX package's ``tools/exp_round3.py``: the same experiment
names and questions, answered on this card with torch ops and the probe
kernels of ``csrc/probes.cu`` (T1, T2) and ``csrc/march_probe.cu`` (T3).

e1   run lengths of equal last face / last tet among adjacent rays still
     blending after k steps, from the tet forward at the tet headline
e2   T1 ``take_rows``: a per-lane gather from a [S, 128] table inside a
     kernel (shared memory when the table fits), at the TPU's 8 rows and at
     the march width, beside ``torch.gather``
e3   T2 ``roll_merge``: the 7-level segmented lane merge of a [G, 12, 128]
     record buffer at the march width
e4   1-D glue at the march width: cumsum, gathers, scatter-add
e5   T3 ``mega_step``: one merged [T, 96] row per ray against the same step
     from the two march tables (``two_table_step``)
e6   scatter-add with random against sorted keys, and a segment sum over
     the sorted keys
e7   the sort-based record reduce: sorts, cumsum + searchsorted + diff, one
     scatter-add
e8   the segmented merge as torch ops on a dense [11, M] log
e10  a dense 17-step backward replay scan (elementwise only)
e12  the sort-reduce at candidate batch sizes

Run: python -m dmesh_renderer_tpu_torch.tools.exp_round3 [which...]
     [--device cuda|cpu]

Times are CUDA events on the card (``_timer``: the mean of ``REPS`` calls,
the minimum of 3 rounds, after one warm-up call), host clock on the CPU.
No failure is caught: a kernel that does not build or launch, or an answer
that disagrees with its plain version, ends the run with an error. The
scatter-adds of e4, e6 and e7 (``index_add``) use atomics on the card;
that is fine for a timing.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..api import resolve_device
from ..kernels import launch
from ..ops.tet import _walk, march_tables, render_tet_forward
from ..utils.scenes import tet_scene

REPS = 8
ROUNDS = 3
LANES = 128
SHIFTS = (1, 2, 4, 8, 16, 32, 64)
MEGA_COLS = 96   # tet geometry 40, ids as f32 8, four shade rows of 12
T3_ROWS = 17     # state and output rows of T3
T3_CONSTS = 10   # ox, oy, oz, dx, dy, dz, then ox, oy, oz, dx again
_K_CF = 3  # T3 state row of the current face


def _timer(dev):
    """``measure(fn)``: ms per call of ``fn()``, the mean of REPS calls,
    the minimum of ROUNDS rounds, after one warm-up call."""
    cuda = dev.type == "cuda"

    def measure(fn):
        fn()
        ts = []
        for _ in range(ROUNDS):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(dev)
                start.record()
                for _ in range(REPS):
                    fn()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / REPS)
            else:
                t0 = time.perf_counter()
                for _ in range(REPS):
                    fn()
                ts.append((time.perf_counter() - t0) * 1e3 / REPS)
        return min(ts)
    return measure


def _on_cuda(name, *tensors):
    """True on CUDA tensors, False on CPU ones; raises otherwise or when the
    tensors do not share a device."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must share a device")
    if dev.type == "cuda":
        return True
    if dev.type != "cpu":
        raise ValueError(f"{name}: unsupported device {dev}")
    return False


def _want(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _aligned16(t):
    """``t`` contiguous and 16-byte aligned (a kernel reads it as float4)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


# =============================================================================
# T1: take_rows (e2)
# =============================================================================

def take_rows(tab, idx):
    """T1: out[r, l] = tab[idx[r, l], l] for tab [S, 128] f32 and idx
    [R, 128] int32 (indices clamped to [0, S)); returns [R, 128] f32.

    On CUDA tensors this launches the kernel of csrc/probes.cu (and raises
    if it cannot); on CPU tensors it runs ``take_rows_plain``."""
    S, R = tab.shape[0], idx.shape[0]
    _want("take_rows", tab, torch.float32, (S, LANES))
    _want("take_rows", idx, torch.int32, (R, LANES))
    if S == 0:
        raise ValueError("take_rows: empty table")
    if not _on_cuda("take_rows", tab, idx):
        return take_rows_plain(tab, idx)
    tab, idx = _aligned16(tab), idx.contiguous()
    out = torch.empty_like(idx, dtype=torch.float32)  # [R, 128]
    launch("probes", "take_rows", [tab, idx, out], [S, R], tab.device)
    take_rows.launches += 1
    return out


take_rows.launches = 0


def take_rows_plain(tab, idx):
    """Plain torch version of ``take_rows``: advanced indexing."""
    lane = torch.arange(LANES, device=tab.device)
    return tab[idx.long().clamp(0, tab.shape[0] - 1), lane]


# =============================================================================
# T2: roll_merge (e3)
# =============================================================================

def roll_merge(buf):
    """T2: the 7-level segmented suffix merge of buf [G, 12, 128] f32 (row
    0 keys, rows 1..11 values): at each level s = 1, 2, ..., 64, in order,
    v[l] += (l < 128 - s and key[l + s] == key[l]) * v[(l + s) % 128].
    Returns [G, 12, 128]: row 0 ones, rows 1..11 the merged values. Every
    group is computed (the TPU grid covers the first (G // 16) * 16).

    On CUDA tensors this launches the kernel of csrc/probes.cu (and raises
    if it cannot); on CPU tensors it runs ``roll_merge_plain``."""
    G = buf.shape[0]
    _want("roll_merge", buf, torch.float32, (G, 12, LANES))
    if not _on_cuda("roll_merge", buf):
        return roll_merge_plain(buf)
    buf = buf.contiguous()
    out = torch.empty_like(buf)
    launch("probes", "roll_merge", [buf, out], [G], buf.device)
    roll_merge.launches += 1
    return out


roll_merge.launches = 0


def roll_merge_plain(buf):
    """Plain torch version of ``roll_merge``: the same f32 ops per level."""
    key = buf[:, 0, :]
    v = buf[:, 1:, :]
    lane = torch.arange(LANES, device=buf.device)
    for s in SHIFTS:
        n = (lane + s) % LANES
        ok = torch.where((lane < LANES - s) & (key[:, n] == key), 1.0, 0.0)
        v = v + ok[:, None, :] * v[:, :, n]
    return torch.cat([torch.ones_like(key)[:, None, :], v], dim=1)


def e3_buffer(M):
    """e3's record buffer [M / 128, 12, 128] f32: keys in runs of 16 (row
    0) and 11 uniform value rows, the draws of the JAX experiment."""
    G = M // LANES
    rng = np.random.RandomState(0)
    keys = np.repeat(rng.randint(0, 1 << 20, M // 16 + 1), 16)[:M]
    buf = np.concatenate([keys.astype(np.float32).reshape(1, -1),
                          rng.rand(11, M).astype(np.float32)], axis=0)
    return torch.from_numpy(
        np.ascontiguousarray(buf.reshape(12, G, LANES).swapaxes(0, 1)))


# =============================================================================
# T3: mega_step and two_table_step (e5)
# =============================================================================

def build_mega(march):
    """The merged march row of every tet [T, 96] f32 from ``march_tables``
    (one view): its geometry (40), its face and neighbour ids as exact f32
    (8), then the shade row of each slot's face (max(id, 0)), 4 x 12."""
    geo, ids, shade = march["tet_geo"], march["tet_ids"], march["shade"]
    T = geo.shape[0]
    tf = ids[:, :4].long().clamp_min(0)
    return torch.cat([geo, ids.to(torch.float32),
                      shade[tf].reshape(T, 48)], dim=1).contiguous()


def _t3_plain(g, ids, sh, consts, state):
    """T3's per-ray f32 arithmetic, vectorised over the rays: geometry rows
    g [M, 40], ids [M, 8] f32, the four slot faces' shade rows sh[j]
    [M, 12]."""
    cf = state[_K_CF]
    is_j = [(ids[:, j] == cf).to(torch.float32) for j in range(4)]

    def col(c):
        return sum(is_j[j] * sh[j][:, c] for j in range(4))

    alpha, l1a, inten = col(9), col(10), col(11)
    u0, v0 = state[1], state[2]
    rgb = []
    for ch in range(3):
        a = col(ch)
        rgb.append((a + (col(3 + ch) - a) * u0 + (col(6 + ch) - a) * v0)
                   * inten)
    w = state[6] * alpha
    err, nf, nt, t2, u2, v2 = _walk(g, ids, cf, [consts[k] for k in range(3)],
                                    [consts[k] for k in range(3, 6)])
    out = state.clone()
    out[0] = rgb[0] * w + alpha * l1a
    out[1] = rgb[1] * w + nf
    out[2] = rgb[2] * w + nt
    out[3] = t2 + u2 + v2 + err.to(torch.float32)
    return out


def _check_t3(name, ct, consts, state):
    M = ct.shape[0]
    _want(name, ct, torch.int32, (M,))
    _want(name, consts, torch.float32, (T3_CONSTS, M))
    _want(name, state, torch.float32, (T3_ROWS, M))


def mega_step(mega, ct, consts, state):
    """T3: one march step per ray from its tet's merged row: mega [T, 96]
    f32 (``build_mega``) gathered by ct [M] int32 (clamped to [0, T)),
    consts [10, M] f32 (origin, direction), state [17, M] f32 (t, u, v,
    current face, current tet, log T, T, ...). Returns [17, M] f32: rows
    0..3 the blend and the walk (col_r w + alpha l1a, col_g w + next face,
    col_b w + next tet, t + u + v + err), rows 4..16 copied from state.

    On CUDA tensors this launches the kernel of csrc/march_probe.cu (and
    raises if it cannot); on CPU tensors it runs ``mega_step_plain``."""
    T, M = mega.shape[0], ct.shape[0]
    _want("mega_step", mega, torch.float32, (T, MEGA_COLS))
    _check_t3("mega_step", ct, consts, state)
    if not _on_cuda("mega_step", mega, ct, consts, state):
        return mega_step_plain(mega, ct, consts, state)
    ins = [x.contiguous() for x in (mega, ct, consts, state)]
    out = torch.empty_like(ins[3])
    launch("march_probe", "mega_step", ins + [out], [M, T], mega.device)
    mega_step.launches += 1
    return out


mega_step.launches = 0


def mega_step_plain(mega, ct, consts, state):
    """Plain torch version of ``mega_step``."""
    row = mega[ct.long().clamp(0, mega.shape[0] - 1)]
    return _t3_plain(row[:, :40], row[:, 40:48],
                     [row[:, 48 + 12 * j:60 + 12 * j] for j in range(4)],
                     consts, state)


def two_table_step(tet_geo, tet_ids, shade, ct, consts, state):
    """T3's second entry: the same function as ``mega_step`` from the march
    tables as the renderer keeps them, tet_geo [T, 40] f32 and tet_ids
    [T, 8] int32 by ct, and shade [F, 12] f32 by each slot's face id
    (clamped to [0, F)). The outputs equal ``mega_step``'s on the mega
    table of the same tables.

    On CUDA tensors this launches the kernel of csrc/march_probe.cu (and
    raises if it cannot); on CPU tensors it runs ``two_table_step_plain``."""
    T, F, M = tet_geo.shape[0], shade.shape[0], ct.shape[0]
    _want("two_table_step", tet_geo, torch.float32, (T, 40))
    _want("two_table_step", tet_ids, torch.int32, (T, 8))
    _want("two_table_step", shade, torch.float32, (F, 12))
    _check_t3("two_table_step", ct, consts, state)
    if not _on_cuda("two_table_step", tet_geo, tet_ids, shade, ct, consts,
                    state):
        return two_table_step_plain(tet_geo, tet_ids, shade, ct, consts,
                                    state)
    ins = [x.contiguous() for x in (tet_geo, tet_ids, shade, ct, consts,
                                    state)]
    out = torch.empty_like(ins[5])
    launch("march_probe", "two_table_step", ins + [out], [M, T, F],
           tet_geo.device)
    two_table_step.launches += 1
    return out


two_table_step.launches = 0


def two_table_step_plain(tet_geo, tet_ids, shade, ct, consts, state):
    """Plain torch version of ``two_table_step``."""
    c = ct.long().clamp(0, tet_geo.shape[0] - 1)
    ids = tet_ids[c]
    sh = [shade[ids[:, j].long().clamp(0, shade.shape[0] - 1)]
          for j in range(4)]
    return _t3_plain(tet_geo[c], ids.to(torch.float32), sh, consts, state)


def scene(n_grid=20):
    """The experiments' tet scene as NumPy arrays: (verts, tets, faces,
    face_tets, tet_faces, verts_color, faces_opacity, faces_intense [1, F])
    of ``freudenthal_grid(n_grid, 0.15, 2)`` with the JAX tool's
    ``RandomState(0)`` draws (the tet bench scene's)."""
    (verts, faces, vcolor, fop, _mv, _proj, _vd, fint, tets, face_tets,
     tet_faces, _bg) = tet_scene(n_grid, 1, 0, 0)
    return verts, tets, faces, face_tets, tet_faces, vcolor, fop, fint


def e5_inputs(dev, n_grid=20, M=640_000):
    """e5's step inputs on ``dev``: the march tables of ``scene(n_grid)``,
    their mega table, and M rays of the JAX tool's ``RandomState(0)``
    draws: ct sorted, the current face a random slot of ct's tet, random
    origins and directions in [0, 1). Returns (march, mega, ct, consts,
    state)."""
    verts, tets, faces, face_tets, tet_faces, vcolor, fop, fint = scene(n_grid)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    march = march_tables(t(verts), t(faces), t(tets), t(tet_faces),
                         t(face_tets), t(vcolor), t(fop), t(fint))
    mega = build_mega(march)
    T = tets.shape[0]
    tf_np = np.maximum(tet_faces, 0)
    rng = np.random.RandomState(0)
    ct = np.sort(rng.randint(0, T, M).astype(np.int32))
    cf = tf_np[ct, rng.randint(0, 4, M)].astype(np.int32)
    ro = [rng.rand(M).astype(np.float32) for _ in range(3)]
    rd = [rng.rand(M).astype(np.float32) for _ in range(3)]
    consts = np.stack(ro + rd + [ro[0], ro[1], ro[2], rd[0]])
    zero = np.zeros(M, np.float32)
    one = np.ones(M, np.float32)
    state = np.stack([zero, zero, zero, cf.astype(np.float32),
                      ct.astype(np.float32), zero, one, zero, zero, zero,
                      zero, zero, -one, -one, zero, zero, zero])
    return march, mega, t(ct), t(consts), t(state)


# =============================================================================
# The experiments
# =============================================================================

def e1(dev, n_grid=20, height=800, width=800, steps=(1, 2, 4, 8, 12)):
    """Run lengths of last face / last tet among adjacent rays that blended
    at step k, from the tet forward with ``max_steps`` k. The port's march
    runs each ray's whole walk in one thread, so there is no compaction to
    switch off."""
    *arrs, bg = tet_scene(n_grid, 1, height, width)
    u = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrs]
    mv_t = u[4].transpose(1, 2).contiguous()
    proj_t = u[5].transpose(1, 2).contiguous()
    fargs = (u[0], u[1], u[2], u[3], mv_t, proj_t, torch.linalg.inv(mv_t),
             torch.linalg.inv(proj_t), u[7], u[8], u[9], u[10],
             torch.from_numpy(bg).to(dev))
    res = {}
    for k in steps:
        _c, _d, _a, saved = render_tet_forward(*fargs, height, width, 0,
                                               max_steps=k)
        lf, lt, nc = (saved[n].reshape(-1).cpu().numpy()
                      for n in ("last_face", "last_tet", "n_contrib"))
        alive = nc >= k

        def runstats(key):
            start = alive.copy()
            start[1:] &= (~alive[:-1]) | (key[1:] != key[:-1])
            return float(alive.sum() / max(1, int(start.sum())))

        res[k] = (int(alive.sum()), runstats(lf), runstats(lt))
        print(f"step {k:3d}: alive={res[k][0]:7d} mean cf-run={res[k][1]:6.1f}"
              f" mean ct-run={res[k][2]:6.1f}", flush=True)
    return res


def e2(dev, sizes=(8, 32, 64, 512, 48_000), rows=(8, 5_000)):
    """T1 at the TPU's 8 rows and at the march width (5,000 rows of 128
    lookups) for every table size, beside ``torch.gather``."""
    measure = _timer(dev)
    rng = np.random.RandomState(0)
    res = {}
    for S in sizes:
        tab = torch.from_numpy(rng.rand(S, LANES).astype(np.float32)).to(dev)
        for R in rows:
            idx = torch.from_numpy(
                rng.randint(0, S, (R, LANES)).astype(np.int32)).to(dev)
            idx64 = idx.long()
            if not torch.equal(take_rows(tab, idx),
                               torch.gather(tab, 0, idx64)):
                raise AssertionError(f"e2: take_rows S={S} R={R} differs "
                                     "from torch.gather")
            ms = measure(lambda: take_rows(tab, idx))
            g_ms = measure(lambda: torch.gather(tab, 0, idx64))
            res[(S, R)] = (ms, g_ms)
            print(f"e2 take_rows S={S} R={R}: OK {ms:.4f} ms; torch.gather "
                  f"{g_ms:.4f} ms", flush=True)
    return res


def e3(dev, M=640_000):
    """T2 on a [M / 128, 12, 128] buffer, keys in runs of 16."""
    buf = e3_buffer(M).to(dev)
    if not torch.equal(roll_merge(buf), roll_merge_plain(buf)):
        raise AssertionError("e3: roll_merge differs from its plain version")
    ms = _timer(dev)(lambda: roll_merge(buf))
    print(f"e3 roll-merge kernel [{M}x12]: {ms:.4f} ms/step", flush=True)
    return {"ms": ms}


def e4(dev, M=640_000, n_acc=100_000):
    """1-D glue costs at the march width."""
    measure = _timer(dev)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(M).astype(np.float32)).to(dev)
    idx = torch.from_numpy(np.sort(rng.randint(0, M, M // 16))).to(dev)
    rows = torch.from_numpy(rng.rand(M, 12).astype(np.float32)).to(dev)
    acc = torch.zeros((n_acc, 12), device=dev)
    idx_acc = idx % n_acc
    part = rows[:M // 16]
    res = {"cumsum": measure(lambda: torch.cumsum(x, 0)),
           "gather_1d": measure(lambda: x[idx]),
           "gather_rows": measure(lambda: rows[idx]),
           "scatter_add_rows": measure(
               lambda: acc.index_add(0, idx_acc, part))}
    print(f"e4 cumsum [M]: {res['cumsum']:.4f} ms", flush=True)
    print(f"e4 1-D gather M/16 from [M]: {res['gather_1d']:.4f} ms")
    print(f"e4 row gather M/16 x12 from [M,12]: {res['gather_rows']:.4f} ms")
    print(f"e4 row scatter-add M/16 x12 -> [{n_acc},12]: "
          f"{res['scatter_add_rows']:.4f} ms", flush=True)
    return res


def e5(dev, n_grid=20, M=640_000):
    """T3: one merged mega row per ray against the same step from the two
    march tables; the two outputs must be equal."""
    march, mega, ct, consts, state = e5_inputs(dev, n_grid, M)
    tabs = (march["tet_geo"], march["tet_ids"], march["shade"])
    if not torch.equal(mega_step(mega, ct, consts, state),
                       two_table_step(*tabs, ct, consts, state)):
        raise AssertionError("e5: mega_step and two_table_step differ")
    measure = _timer(dev)
    res = {"two_table_ms": measure(
               lambda: two_table_step(*tabs, ct, consts, state)),
           "mega_ms": measure(lambda: mega_step(mega, ct, consts, state))}
    print(f"e5 two-table step:      {res['two_table_ms']:.4f} ms", flush=True)
    print(f"e5 mega 1-gather step:  {res['mega_ms']:.4f} ms", flush=True)
    return res


def e6(dev, M=640_000, F=98_400):
    """Scatter-add with random against sorted keys; the segment sum over
    the sorted keys (no atomics) in the place of JAX's sorted-indices
    hint."""
    measure = _timer(dev)
    rng = np.random.RandomState(0)
    vals = torch.from_numpy(rng.rand(M, 10).astype(np.float32)).to(dev)
    k_rand = rng.randint(0, F, M)
    k_sort = torch.from_numpy(np.sort(k_rand)).to(dev)
    k_rand = torch.from_numpy(k_rand).to(dev)
    lengths = torch.bincount(k_sort, minlength=F)
    acc = torch.zeros((F, 10), device=dev)
    res = {"scatter_rand": measure(lambda: acc.index_add(0, k_rand, vals)),
           "scatter_sorted": measure(lambda: acc.index_add(0, k_sort, vals)),
           "segment_sum_sorted": measure(lambda: torch.segment_reduce(
               vals, "sum", lengths=lengths))}
    print(f"e6 scatter rand keys: {res['scatter_rand']:.4f} ms")
    print(f"e6 scatter sorted keys: {res['scatter_sorted']:.4f} ms")
    print(f"e6 segment sum sorted keys: {res['segment_sum_sorted']:.4f} ms",
          flush=True)
    return res


def _baseline(measure, dev):
    one = torch.zeros((LANES,), dtype=torch.int32, device=dev)
    return measure(lambda: (one[:1] + 1).to(torch.float32))


def _sorted_sums(ks, vs, F):
    """Per-key sums of vs [10, N] over sorted keys ks [N]: cumsum,
    searchsorted of the key boundaries, difference."""
    colsum = torch.cumsum(vs, dim=1)
    b = torch.searchsorted(ks, torch.arange(F + 1, dtype=ks.dtype,
                                            device=ks.device))
    z = torch.cat([torch.zeros((vs.shape[0], 1), device=vs.device), colsum],
                  dim=1)
    return z[:, b[1:]] - z[:, b[:-1]]


def e7(dev, sizes=(2_000_000, 6_000_000), F=98_400):
    """Sort-based record reduce: [N] int32 keys, 10 value rows, per-face
    sums. Times are not reduced by the dispatch baseline, which is printed
    beside them."""
    measure = _timer(dev)
    rng = np.random.RandomState(0)
    base = _baseline(measure, dev)
    print(f"e7 dispatch baseline: {base:.4f} ms")
    res = {"baseline": base}
    for N in sizes:
        keys = torch.from_numpy(rng.randint(0, F, N).astype(np.int32)).to(dev)
        vals = torch.from_numpy(rng.rand(10, N).astype(np.float32)).to(dev)

        def sort2():
            ks, perm = torch.sort(keys, stable=True)
            return ks, vals[0][perm]

        def sort11():
            ks, perm = torch.sort(keys, stable=True)
            return ks, vals[:, perm]

        keys_sorted = torch.sort(keys, stable=True).values
        acc = torch.zeros((F, 10), device=dev)
        vals_t = vals.t()
        r = {"sort_2op": measure(sort2), "sort_11op": measure(sort11),
             "cumsum_searchsorted_diff": measure(
                 lambda: _sorted_sums(keys_sorted, vals, F)),
             "one_scatter": measure(lambda: acc.index_add(0, keys, vals_t))}
        res[N] = r
        for name, ms in r.items():
            print(f"e7 N={N} {name}: {ms:.4f} ms", flush=True)
    return res


def e8(dev, M=640_000):
    """The 7-level shifted merge as torch ops on a dense [11, M] log."""
    measure = _timer(dev)
    rng = np.random.RandomState(0)
    keys = torch.from_numpy(np.repeat(rng.randint(0, 1 << 20, M // 16 + 1),
                                      16)[:M].astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.rand(11, M).astype(np.float32)).to(dev)

    def merge():
        k, v = keys, vals
        for s in SHIFTS:
            ks = torch.cat([k[s:], torch.full((s,), -1, dtype=k.dtype,
                                              device=dev)])
            same = (ks == k).to(torch.float32)[None]
            vs = torch.cat([v[:, s:], torch.zeros((11, s), device=dev)], 1)
            v = v + same * vs
        return v

    ms = measure(merge)
    print(f"e8 7-level torch-op roll-merge [11, M]: {ms:.4f} ms", flush=True)
    return {"ms": ms}


def e10(dev, M=640_000, S=17):
    """A dense backward replay: S steps of elementwise suffix math over
    [S, 12, M / 128, 128] log slices, in reverse, no gathers or scatters."""
    measure = _timer(dev)
    rng = np.random.RandomState(0)
    log = torch.from_numpy(
        rng.rand(S, 12, M // LANES, LANES).astype(np.float32)).to(dev)

    def replay():
        acc_r = torch.zeros((M // LANES, LANES), device=dev)
        T = torch.ones((M // LANES, LANES), device=dev)
        recs = [None] * S
        for i in range(S - 1, -1, -1):
            sl = log[i]
            col = sl[0] + sl[1]
            alpha = sl[2]
            T = T * (1 - alpha * 0.001)
            acc_r = alpha * col + (1 - alpha) * acc_r
            recs[i] = acc_r * T
        return torch.stack(recs)

    ms = measure(replay)
    print(f"e10 dense {S}-step replay: {ms:.4f} ms", flush=True)
    return {"ms": ms}


def e12(dev, sizes=(640_000, 1_280_000, 2_560_000, 5_120_000), F=98_400):
    """The backward's sort-reduce (stable sort of the keys, the 10 value
    rows permuted, cumsum + searchsorted + diff) at candidate batch sizes,
    and the sort alone."""
    measure = _timer(dev)
    rng = np.random.RandomState(0)
    base = _baseline(measure, dev)
    print(f"e12 dispatch baseline: {base:.4f} ms")
    res = {"baseline": base}
    for N in sizes:
        keys = torch.from_numpy(rng.randint(0, F, N).astype(np.int32)).to(dev)
        vals = torch.from_numpy(rng.rand(10, N).astype(np.float32)).to(dev)

        def sort_only():
            ks, perm = torch.sort(keys, stable=True)
            return ks, vals[:, perm]

        def reduce_batch():
            ks, vs = sort_only()
            return _sorted_sums(ks, vs, F)

        res[N] = {"sort_reduce": measure(reduce_batch),
                  "sort_only": measure(sort_only)}
        print(f"e12 N={N} full sort-reduce: {res[N]['sort_reduce']:.4f} ms")
        print(f"e12 N={N} sort only: {res[N]['sort_only']:.4f} ms",
              flush=True)
    return res


EXPERIMENTS = {"e1": e1, "e2": e2, "e3": e3, "e4": e4, "e5": e5, "e6": e6,
               "e7": e7, "e8": e8, "e10": e10, "e12": e12}
DEFAULT = ("e2", "e3", "e4", "e5", "e6", "e1")


def main(argv=None):
    """Run the named experiments (default: e2 e3 e4 e5 e6 e1) in order on
    ``--device`` (cuda by default) and return {name: its results}."""
    ap = argparse.ArgumentParser(
        prog="python -m dmesh_renderer_tpu_torch.tools.exp_round3",
        description=__doc__.split("\n")[0])
    ap.add_argument("which", nargs="*",
                    help="experiments to run, in order: "
                         + " ".join(EXPERIMENTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = [n for n in args.which if n not in EXPERIMENTS]
    if unknown:
        ap.error(f"unknown experiments {unknown}")
    dev = resolve_device(args.device)
    results = {}
    for name in args.which or DEFAULT:
        print(f"==== {name} ====", flush=True)
        results[name] = EXPERIMENTS[name](dev)
    return results


if __name__ == "__main__":
    main()
