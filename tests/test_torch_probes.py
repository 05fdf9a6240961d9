"""The port's experiment kernels T1-T4 against the JAX package's, on CPU.

The JAX kernels are closures inside ``tools/exp_round3.py`` (e2, e3, e5)
and ``tools/proto_march_kernel.py`` (main), so they cannot be imported.
Each is copied below from its lines and run through
``pl.pallas_call(..., interpret=True)``, with exactly two substitutions,
both needed because the JAX package moved on since the tools were written:

  * T2: ``pltpu.roll(x, 128 - s, 1)`` for ``pltpu.roll(x, -s, 1)`` (JAX 0.9
    rejects a negative shift; the kernel's comment asks for each lane's
    right neighbour at distance s, which a roll by 128 - s gives);
  * T3: ``_NSF = 17`` for ``tet_mod._NSF``, which ``ops/tet.py`` no longer
    defines (e5 builds 17 state rows).

``tet._connectivity_step`` is the JAX package's own. The port runs its
plain versions (the wrappers on CPU tensors). Both sides get the same
inputs. Tolerances: T1 and T2 exact (T2 also against a NumPy spec); T3 and
T4 float rows within 1e-5 relative (max(1, |x|)), the lanes beyond it
pinned at the observed count (none on these inputs): XLA:CPU may contract
a*b + c into FMAs where the port rounds each op (ROADMAP hazard e); the
two plain T3 entries bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl
from jax.experimental.pallas import tpu as pltpu
import pytest
import torch

from dmesh_renderer_tpu.ops import tet as tet_mod
from dmesh_renderer_tpu.ops.binning import _relayout
from dmesh_renderer_tpu.runtime.native import build_tet_connectivity
from dmesh_renderer_tpu.utils.connectivity import freudenthal_grid
from dmesh_renderer_tpu_torch.ops.tet import _walk
from dmesh_renderer_tpu_torch.tools import exp_round3 as ex
from dmesh_renderer_tpu_torch.tools import proto_march_kernel as pm

RTOL = 1e-5
# lanes of T3 and T4 whose float rows differ beyond RTOL (observed: 0)
T3_BAD_LANES = 0
T4_BAD_LANES = 0


def _rel_bad(got, want):
    """Per lane (column), whether any row differs beyond RTOL relative to
    max(1, |want|)."""
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return (d > RTOL * np.maximum(1.0, np.abs(want))).any(axis=0)


# =============================================================================
# T1 (exp_round3.py:151-165, e2)
# =============================================================================

def _t1_jax(tab, idx):
    def kernel(tab_ref, idx_ref, out_ref):
        out_ref[:, :] = jnp.take_along_axis(
            tab_ref[:, :], idx_ref[:, :], axis=0)

    return np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(tab), jnp.asarray(idx)))


@pytest.mark.parametrize("S", [8, 64, 512])
def test_take_rows_matches_jax(S):
    rng = np.random.RandomState(S)
    tab = rng.rand(S, 128).astype(np.float32)
    idx = rng.randint(0, S, (8, 128)).astype(np.int32)
    got = ex.take_rows(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), _t1_jax(tab, idx))
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(tab, idx, axis=0))


def test_take_rows_clamps_and_checks():
    tab = torch.arange(4 * 128, dtype=torch.float32).reshape(4, 128)
    idx = torch.full((2, 128), 9, dtype=torch.int32)
    idx[1] = -3
    out = ex.take_rows(tab, idx)
    assert torch.equal(out[0], tab[3]) and torch.equal(out[1], tab[0])
    with pytest.raises(TypeError):
        ex.take_rows(tab, idx.long())
    with pytest.raises(ValueError):
        ex.take_rows(tab[:, :64], idx)


# =============================================================================
# T2 (exp_round3.py:194-213, e3)
# =============================================================================

def _t2_jax(buf_t, BQ=16):
    G = buf_t.shape[0]

    def kernel(in_ref, out_ref):
        key = in_ref[:, 0, :]
        vals = [in_ref[:, 1 + r, :] for r in range(11)]
        for shift in (1, 2, 4, 8, 16, 32, 64):
            kshift = pltpu.roll(key, 128 - shift, 1)  # substitution (T2)
            same = (kshift == key).astype(jnp.float32)
            lane = jax.lax.broadcasted_iota(jnp.int32, key.shape, 1)
            ok = jnp.where(lane < 128 - shift, same, 0.0)
            vals = [v + ok * pltpu.roll(v, 128 - shift, 1)  # substitution
                    for v in vals]
        is_start = jnp.ones_like(key)
        out_ref[:, 0, :] = is_start
        for r in range(11):
            out_ref[:, 1 + r, :] = vals[r]

    return np.asarray(pl.pallas_call(
        kernel,
        grid=(G // BQ,),
        in_specs=[pl.BlockSpec((BQ, 12, 128), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((BQ, 12, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((G, 12, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(buf_t)))


def _t2_numpy(buf):
    """The spec, lane by lane: 7 levels, each reading the previous one."""
    out = buf.copy()
    out[:, 0] = 1.0
    with np.errstate(invalid="ignore"):  # 0 * inf
        for g in range(buf.shape[0]):
            key = buf[g, 0]
            v = buf[g, 1:].copy()
            for s in (1, 2, 4, 8, 16, 32, 64):
                prev = v.copy()
                for lane in range(128):
                    ok = np.float32(
                        lane < 128 - s and key[lane + s] == key[lane])
                    v[:, lane] = (prev[:, lane]
                                  + ok * prev[:, (lane + s) % 128])
            out[g, 1:] = v
    return out


def _t2_tool_buffer(M):
    """e3's buffer as the JAX tool builds it (exp_round3.py:185-192)."""
    G = M // 128
    rng = np.random.RandomState(0)
    keys = np.repeat(rng.randint(0, 1 << 20, M // 16 + 1), 16)[:M]
    buf = np.concatenate([
        keys.astype(np.float32).reshape(1, -1),
        rng.rand(11, M).astype(np.float32)], axis=0)
    return np.ascontiguousarray(buf.reshape(12, G, 128).swapaxes(0, 1))


@pytest.mark.parametrize("G", [32, 40])
def test_roll_merge_matches_jax_and_spec(G):
    buf = ex.e3_buffer(G * 128)
    np.testing.assert_array_equal(buf.numpy(), _t2_tool_buffer(G * 128))
    # a few keys equal across the runs' borders, and an inf in lane 0,
    # which lane 127 reads through the wrap with a zero mask: the product
    # 0 * inf is NaN, as on the TPU (a select would keep lane 127 finite)
    buf[:, 0, 60:70] = 7.0
    buf[0, 3, 0] = np.inf
    got = ex.roll_merge(buf).numpy()
    covered = (G // 16) * 16  # the TPU grid leaves the rest unwritten
    want = _t2_jax(buf.numpy())
    np.testing.assert_array_equal(got[:covered], want[:covered])
    np.testing.assert_array_equal(got, _t2_numpy(buf.numpy()))


# =============================================================================
# T3 (exp_round3.py:252-356, e5)
# =============================================================================

_NSF = 17  # substitution (T3): tet_mod._NSF no longer exists


def _t3_jax(mega_rows, consts_t, state_t):
    M = mega_rows.shape[0]

    def mega_kernel(mega_ref, consts_ref, state_ref, out_ref):
        s = lambda r: state_ref[:, r, :]
        cf_ = s(tet_mod._K_CF)
        is_j = [(mega_ref[:, 40 + j, :] == cf_).astype(jnp.float32)
                for j in range(4)]

        def shade_col(c):
            return sum(is_j[j] * mega_ref[:, 48 + 12 * j + c, :]
                       for j in range(4))
        alpha = shade_col(9)
        l1a = shade_col(10)
        inten = shade_col(11)
        u0, v0 = s(tet_mod._K_U), s(tet_mod._K_V)
        col = [(shade_col(ch) + (shade_col(3 + ch) - shade_col(ch)) * u0
                + (shade_col(6 + ch) - shade_col(ch)) * v0) * inten
               for ch in range(3)]
        w = s(tet_mod._K_TCUR) * alpha
        err, nf, nt, t2, u2, v2 = tet_mod._connectivity_step(
            lambda k: mega_ref[:, k, :], cf_,
            consts_ref[:, 0, :], consts_ref[:, 1, :], consts_ref[:, 2, :],
            consts_ref[:, 3, :], consts_ref[:, 4, :], consts_ref[:, 5, :],
            +1)
        out_ref[:, 0, :] = col[0] * w + alpha * l1a
        out_ref[:, 1, :] = col[1] * w + nf
        out_ref[:, 2, :] = col[2] * w + nt
        out_ref[:, 3, :] = t2 + u2 + v2 + err.astype(jnp.float32)
        for r in range(4, _NSF):
            out_ref[:, r, :] = s(r)

    g = M // 128
    bq = tet_mod._pick_bq(g)
    out = pl.pallas_call(
        mega_kernel,
        grid=(g // bq,),
        in_specs=[
            pl.BlockSpec((bq, 96, 128), lambda i: (i, 0, 0)),
            pl.BlockSpec((bq, 10, 128), lambda i: (i, 0, 0)),
            pl.BlockSpec((bq, _NSF, 128), lambda i: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((bq, _NSF, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((g, _NSF, 128), jnp.float32),
        interpret=True,
    )(_relayout(jnp.asarray(mega_rows), 96), consts_t, state_t)
    return np.asarray(out).swapaxes(0, 1).reshape(_NSF, M)


@pytest.fixture(scope="module")
def t3_case():
    """e5's inputs at freudenthal_grid(4) and 2048 rays, built by the JAX
    tool's lines (:257-287) and by the port's ``e5_inputs``."""
    verts, tets = freudenthal_grid(4, jitter=0.15, seed=2)
    faces, face_tets, tet_faces = build_tet_connectivity(tets)
    rng = np.random.RandomState(0)
    vcolor = jnp.asarray(rng.rand(verts.shape[0], 3).astype(np.float32))
    fop = jnp.asarray(rng.uniform(0.3, 0.9, faces.shape[0]).astype(np.float32))
    fint = jnp.asarray(
        rng.uniform(0.5, 1.0, (1, faces.shape[0])).astype(np.float32))
    march = tet_mod._march_tables(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(tets),
        jnp.asarray(tet_faces), jnp.asarray(face_tets), vcolor, fop, fint)
    pack, shade = march["tet_pack"], march["shade"]
    T = pack.shape[0]
    tf_np = np.maximum(np.asarray(tet_faces), 0)
    mega = np.array(jnp.concatenate(
        [pack, jnp.asarray(np.asarray(shade)[tf_np].reshape(T, 48))], axis=1))

    M = 2048
    rng = np.random.RandomState(0)
    ct = np.sort(rng.randint(0, T, M).astype(np.int32))
    cf = tf_np[ct, rng.randint(0, 4, M)].astype(np.int32)
    ro = [jnp.asarray(rng.rand(M).astype(np.float32)) for _ in range(3)]
    rd = [jnp.asarray(rng.rand(M).astype(np.float32)) for _ in range(3)]
    consts_t = tet_mod._pack_rows(ro + rd + [ro[0], ro[1], ro[2], rd[0]])
    zero = jnp.zeros((M,), jnp.float32)
    one = jnp.ones((M,), jnp.float32)
    state_t = tet_mod._pack_rows(
        [zero, zero, zero, jnp.asarray(cf.astype(np.float32)),
         jnp.asarray(ct.astype(np.float32)),
         zero, one, zero, zero, zero, zero, zero, -one, -one, zero, zero,
         zero])
    want = _t3_jax(mega[ct], consts_t, state_t)
    port = ex.e5_inputs(torch.device("cpu"), n_grid=4, M=M)
    return dict(mega=mega, shade=np.array(shade), ct=ct, want=want,
                consts=np.asarray(consts_t).swapaxes(0, 1).reshape(10, M),
                state=np.asarray(state_t).swapaxes(0, 1).reshape(_NSF, M),
                port=port)


def test_e5_inputs_match_the_tool(t3_case):
    """The port's e5 inputs are the JAX tool's: the rays bit for bit, the
    mega table up to the log(1 - alpha) column (the two CPUs' log differ in
    the last bit)."""
    march, mega, ct, consts, state = t3_case["port"]
    np.testing.assert_array_equal(ct.numpy(), t3_case["ct"])
    np.testing.assert_array_equal(consts.numpy(), t3_case["consts"])
    np.testing.assert_array_equal(state.numpy(), t3_case["state"])
    want = t3_case["mega"]
    l1a = [48 + 12 * j + 10 for j in range(4)]
    keep = [c for c in range(96) if c not in l1a]
    np.testing.assert_array_equal(mega.numpy()[:, keep], want[:, keep])
    np.testing.assert_allclose(mega.numpy()[:, l1a], want[:, l1a],
                               rtol=1e-6, atol=0)


def test_mega_step_matches_jax(t3_case):
    c = t3_case
    t = torch.from_numpy
    got = ex.mega_step(t(c["mega"]), t(c["ct"]), t(c["consts"]),
                       t(c["state"])).numpy()
    want = c["want"]
    assert want.shape == got.shape == (_NSF, 2048)
    np.testing.assert_array_equal(got[4:], want[4:])
    assert int(_rel_bad(got, want).sum()) == T3_BAD_LANES
    # the step did real work: some walks are valid, some err
    rows = torch.from_numpy(c["mega"][c["ct"]])
    k = torch.from_numpy(c["consts"])
    err = _walk(rows[:, :40], rows[:, 40:48], torch.from_numpy(c["state"][3]),
                [k[0], k[1], k[2]], [k[3], k[4], k[5]])[0]
    assert np.isfinite(got).all() and 0 < int(err.sum()) < 2048


def test_two_table_step_equals_mega_step(t3_case):
    """The two plain T3 entries agree bit for bit, on the JAX tables and on
    the port's own."""
    c = t3_case
    t = torch.from_numpy
    mega, ct, consts, state = (t(c["mega"]), t(c["ct"]), t(c["consts"]),
                               t(c["state"]))
    a = ex.mega_step(mega, ct, consts, state)
    b = ex.two_table_step(mega[:, :40].contiguous(),
                          mega[:, 40:48].to(torch.int32),
                          t(c["shade"]), ct, consts, state)
    assert torch.equal(a, b)
    march, pmega, pct, pconsts, pstate = c["port"]
    assert torch.equal(
        ex.mega_step(pmega, pct, pconsts, pstate),
        ex.two_table_step(march["tet_geo"], march["tet_ids"],
                          march["shade"], pct, pconsts, pstate))


# =============================================================================
# T4 (proto_march_kernel.py:54-187)
# =============================================================================

def _t4_jax_chain(a, M, F, T, steps):
    G = M // 128
    BQ = 16

    def relayout(rows, k):
        return jax.lax.optimization_barrier(
            rows.reshape(G, 128, k).swapaxes(1, 2))

    def kernel(pack_ref, shade_ref, consts_ref, state_ref, out_ref):
        dx = consts_ref[:, 3, :]
        dy = consts_ref[:, 4, :]
        dz = consts_ref[:, 5, :]
        ox = consts_ref[:, 0, :]
        oy = consts_ref[:, 1, :]
        oz = consts_ref[:, 2, :]
        cf = state_ref[:, 3, :]
        t0 = state_ref[:, 0, :]
        u0 = state_ref[:, 1, :]
        v0 = state_ref[:, 2, :]

        n_other = jnp.zeros_like(dx)
        n_exit = jnp.zeros_like(dx)
        d_entry = jnp.zeros_like(dx)
        nt_ = nu_ = nv_ = nface = ntet = None
        for j in range(4):
            p0x = pack_ref[:, 9 * j + 0, :]
            p0y = pack_ref[:, 9 * j + 1, :]
            p0z = pack_ref[:, 9 * j + 2, :]
            e1x = pack_ref[:, 9 * j + 3, :]
            e1y = pack_ref[:, 9 * j + 4, :]
            e1z = pack_ref[:, 9 * j + 5, :]
            e2x = pack_ref[:, 9 * j + 6, :]
            e2y = pack_ref[:, 9 * j + 7, :]
            e2z = pack_ref[:, 9 * j + 8, :]
            sgn = pack_ref[:, 36 + j, :]
            tfj = pack_ref[:, 40 + j, :]
            nbj = pack_ref[:, 44 + j, :]
            nx = e1y * e2z - e1z * e2y
            ny = e1z * e2x - e1x * e2z
            nz = e1x * e2y - e1y * e2x
            nn = jnp.maximum(jnp.sqrt(nx * nx + ny * ny + nz * nz), 1e-4)
            outd = sgn * ((nx / nn) * dx + (ny / nn) * dy + (nz / nn) * dz)
            tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            den = pvx * e1x + pvy * e1y + pvz * e1z
            nd = den != 0.0
            inv = 1.0 / jnp.where(nd, den, 1.0)
            t = (qvx * e2x + qvy * e2y + qvz * e2z) * inv
            u = (pvx * tvx + pvy * tvy + pvz * tvz) * inv
            v = (qvx * dx + qvy * dy + qvz * dz) * inv
            hit = nd & (t >= 0) & (u >= 0) & (v >= 0) & (u + v <= 1.0)
            is_entry = tfj == cf
            other = ~is_entry
            n_other = n_other + other.astype(jnp.float32)
            d_entry = d_entry + jnp.where(is_entry, outd, 0.0)
            ex_ = other & hit & (outd > 0.0)
            n_exit = n_exit + ex_.astype(jnp.float32)
            if j == 0:
                nt_, nu_, nv_, nface, ntet = t, u, v, tfj, nbj
            else:
                nt_ = jnp.where(ex_, t, nt_)
                nu_ = jnp.where(ex_, u, nu_)
                nv_ = jnp.where(ex_, v, nv_)
                nface = jnp.where(ex_, tfj, nface)
                ntet = jnp.where(ex_, nbj, ntet)
        err = (n_other != 3.0) | (d_entry >= 0.0) | (n_exit != 1.0)

        alpha = shade_ref[:, 9, :]
        l1a = shade_ref[:, 10, :]
        inten = shade_ref[:, 11, :]
        Tc = state_ref[:, 5, :]
        w = Tc * alpha
        colr = (shade_ref[:, 0, :]
                + (shade_ref[:, 3, :] - shade_ref[:, 0, :]) * u0
                + (shade_ref[:, 6, :] - shade_ref[:, 0, :]) * v0) * inten
        colg = (shade_ref[:, 1, :]
                + (shade_ref[:, 4, :] - shade_ref[:, 1, :]) * u0
                + (shade_ref[:, 7, :] - shade_ref[:, 1, :]) * v0) * inten
        colb = (shade_ref[:, 2, :]
                + (shade_ref[:, 5, :] - shade_ref[:, 2, :]) * u0
                + (shade_ref[:, 8, :] - shade_ref[:, 2, :]) * v0) * inten
        dep = (consts_ref[:, 6, :] + t0 * consts_ref[:, 8, :]) / (
            consts_ref[:, 7, :] + t0 * consts_ref[:, 9, :] + 1e-4)
        logT = state_ref[:, 4, :] + l1a
        Tc2 = jnp.exp(logT)
        adv = ~err & (Tc2 > 1e-4)

        out_ref[:, 0, :] = jnp.where(adv, nt_, t0)
        out_ref[:, 1, :] = jnp.where(adv, nu_, u0)
        out_ref[:, 2, :] = jnp.where(adv, nv_, v0)
        out_ref[:, 3, :] = jnp.where(adv, nface, cf)
        out_ref[:, 4, :] = logT
        out_ref[:, 5, :] = Tc2
        out_ref[:, 6, :] = state_ref[:, 6, :] + colr * w
        out_ref[:, 7, :] = state_ref[:, 7, :] + colg * w
        out_ref[:, 8, :] = state_ref[:, 8, :] + colb * w
        out_ref[:, 9, :] = state_ref[:, 9, :] + dep * w
        out_ref[:, 10, :] = jnp.where(adv, ntet, state_ref[:, 10, :])
        out_ref[:, 11, :] = err.astype(jnp.float32)
        out_ref[:, 12, :] = state_ref[:, 12, :] + 1.0
        out_ref[:, 13, :] = state_ref[:, 13, :]
        out_ref[:, 14, :] = state_ref[:, 14, :]
        out_ref[:, 15, :] = state_ref[:, 15, :]

    consts_t = a["consts"].T.reshape(G, 128, 16).swapaxes(1, 2)
    state_t = a["state"].T.reshape(G, 128, 16).swapaxes(1, 2)
    cf, ct = a["cf"], a["ct"]
    for _ in range(steps):
        pack = relayout(a["tet_pack"][ct], 48)
        shade = relayout(a["shade"][cf], 12)
        state_t = pl.pallas_call(
            kernel,
            grid=(G // BQ,),
            in_specs=[
                pl.BlockSpec((BQ, 48, 128), lambda i: (i, 0, 0)),
                pl.BlockSpec((BQ, 12, 128), lambda i: (i, 0, 0)),
                pl.BlockSpec((BQ, 16, 128), lambda i: (i, 0, 0)),
                pl.BlockSpec((BQ, 16, 128), lambda i: (i, 0, 0)),
            ],
            out_specs=pl.BlockSpec((BQ, 16, 128), lambda i: (i, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((G, 16, 128), jnp.float32),
            interpret=True,
        )(pack, shade, consts_t, state_t)
        cf = state_t[:, 3, :].reshape(M).astype(jnp.int32) % F
        ct = state_t[:, 10, :].reshape(M).astype(jnp.int32) % T
    return (np.asarray(state_t).swapaxes(0, 1).reshape(16, M),
            np.asarray(cf), np.asarray(ct))


def _t4_case(M):
    """The tool's random tables (proto_march_kernel.py:38-48) at M rays."""
    rng = np.random.RandomState(0)
    return {"tet_pack": rng.rand(pm.T, 48).astype(np.float32),
            "shade": rng.rand(pm.F, 12).astype(np.float32),
            "ct": rng.randint(0, pm.T, M).astype(np.int32),
            "cf": rng.randint(0, pm.F, M).astype(np.int32),
            "consts": rng.rand(16, M).astype(np.float32),
            "state": rng.rand(16, M).astype(np.float32)}


def _t4_mesh_case(t3):
    """T4 on a real mesh, so that walks are valid and rays advance: e5's
    tables and rays (the pack is the mega row's first 48 columns), log T 0
    and T 1, the ray's tet in row 10."""
    M = t3["ct"].shape[0]
    rng = np.random.RandomState(3)
    state = np.zeros((16, M), np.float32)
    state[3] = t3["state"][3]
    state[5] = 1.0
    state[10] = t3["ct"]
    return {"tet_pack": np.ascontiguousarray(t3["mega"][:, :48]),
            "shade": t3["shade"], "ct": t3["ct"],
            "cf": t3["state"][3].astype(np.int32),
            "consts": np.concatenate(
                [t3["consts"], rng.rand(6, M).astype(np.float32)]),
            "state": state}


def test_random_tables_are_the_tools():
    a = _t4_case(2048)
    got = pm.random_tables(torch.device("cpu"), M=2048)
    for k, x in zip(("tet_pack", "shade", "ct", "cf", "consts", "state"),
                    got):
        np.testing.assert_array_equal(x.numpy(), a[k])


def test_mesh_tables_are_the_mesh_case(t3_case):
    """``mesh_tables`` builds the mesh case the JAX comparison runs: the
    pack and the rays bit for bit, the shade table up to its log(1 - alpha)
    column (the two CPUs' log differ in the last bit)."""
    a = _t4_mesh_case(t3_case)
    got = pm.mesh_tables(torch.device("cpu"), n_grid=4, M=2048)
    for k, x in zip(("tet_pack", "ct", "cf", "consts", "state"),
                    got[:1] + got[2:]):
        np.testing.assert_array_equal(x.numpy(), a[k])
    keep = [c for c in range(12) if c != 10]
    np.testing.assert_array_equal(got[1].numpy()[:, keep], a["shade"][:, keep])
    np.testing.assert_allclose(got[1].numpy()[:, 10], a["shade"][:, 10],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", ["tool", "mesh"])
def test_proto_chain_matches_jax(case, t3_case):
    M, steps = 2048, 2
    a = _t4_case(M) if case == "tool" else _t4_mesh_case(t3_case)
    T, F = a["tet_pack"].shape[0], a["shade"].shape[0]
    want, wcf, wct = _t4_jax_chain({k: jnp.asarray(v) for k, v in a.items()},
                                   M, F, T, steps)
    t = torch.from_numpy
    got, gcf, gct = pm.chain(t(a["tet_pack"]), t(a["shade"]), t(a["ct"]),
                             t(a["cf"]), t(a["consts"]), t(a["state"]),
                             steps=steps)
    got = got.numpy()
    assert np.isfinite(got).all()
    assert int(_rel_bad(got, want).sum()) == T4_BAD_LANES
    np.testing.assert_array_equal(got[11], want[11])  # error flags
    np.testing.assert_array_equal(gcf.numpy(), wcf)
    np.testing.assert_array_equal(gct.numpy(), wct)
    if case == "tool":
        # the tool's tables: every lane errs, none advances, and the ids
        # collapse to row 0 after step 1
        assert (got[11] == 1.0).all()
        assert not gcf.any() and not gct.any()
    else:
        # some rays advanced through both steps, others stopped on an error
        assert 0 < (got[11] == 0.0).sum() < M
        assert (got[10] != a["state"][10]).any()


def test_cli_runs_on_cpu_and_rejects_unknown_names(capsys):
    res = ex.main(["e2", "--device", "cpu"])
    assert set(res["e2"]) == {(S, R) for S in (8, 32, 64, 512, 48_000)
                              for R in (8, 5_000)}
    assert "e2 take_rows S=48000 R=5000: OK" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        ex.main(["e9", "--device", "cpu"])
