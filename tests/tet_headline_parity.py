"""The torch port's tet forward against the JAX package's at the tet
headline scene (98,400 faces, 48,000 tets, 800x800, B=1), both on the CPU,
and a trace of every pixel where they disagree.

    JAX_PLATFORMS=cpu python tests/tet_headline_parity.py   # ~3 minutes

Not a test (it is too slow for the suite): a diagnostic. It prints the
first-hit pixels, active pixels, longest walk and blend events of both, and
for each pixel whose first face, active flag or n_contrib differs, the f64
quantities of the decision that split them:

- a first face that differs: the t of both faces in f64 (a near tie, when
  two faces meet the ray at the same point of their shared edge);
- a walk that differs: along the port's walk, the step and slot whose
  strict hit test or exit-direction test lies nearest its threshold
  (min |u|, |v|, |1-u-v|, |outd|), replayed in f64.

Both packages round their f32 operations differently: the port rounds each
op as the JAX source is written, XLA:CPU contracts some a*b+c into FMAs.

Last, it runs the port again with its exp and log taken in f64 and rounded
to f32, and counts the pixels that this moves: a pixel whose log T lies
within rounding of log(T_EPS) at some step terminates one step earlier or
later with another exp or log, and every CPU or card rounds those two
differently.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dmesh_renderer_tpu.ops import tet as jt  # noqa: E402
from dmesh_renderer_tpu_torch.convert import tet_args_from_numpy  # noqa: E402
from dmesh_renderer_tpu_torch.ops import tet as pt  # noqa: E402
from dmesh_renderer_tpu_torch.utils.scenes import tet_scene  # noqa: E402

H = W = 800
INT_KEYS = ("first_face", "last_face", "last_tet", "n_contrib", "is_active")


def walk_margins(cf, ct, d, o, m, steps):
    """Replay the port's walk of one ray in f64 for ``steps`` steps; return
    (smallest margin, its step, its slot)."""
    best = (np.inf, -1, -1)
    for s in range(steps):
        if ct < 0:
            break
        g = m["tet_geo"][ct].numpy().astype(np.float64)
        ids = m["tet_ids"][ct].numpy()
        exits = []
        for j in range(4):
            p0, e1, e2 = g[9 * j:9 * j + 3], g[9 * j + 3:9 * j + 6], \
                g[9 * j + 6:9 * j + 9]
            n = np.cross(e1, e2)
            outd = g[36 + j] * (n / max(np.linalg.norm(n), 1e-4)) @ d
            pv, tv = np.cross(d, e2), o - p0
            qv = np.cross(tv, e1)
            den = pv @ e1
            t, u, v = qv @ e2 / den, pv @ tv / den, qv @ d / den
            if ids[j] == cf:
                continue
            margin = min(abs(u), abs(v), abs(1 - u - v), abs(outd))
            best = min(best, (margin, s, j))
            if t >= 0 and u >= 0 and v >= 0 and u + v <= 1 and outd > 0:
                exits.append((int(ids[j]), int(ids[4 + j])))
        if len(exits) != 1:
            break
        cf, ct = exits[0]
    return best


def main():
    (v, f, vc, fo, mv, proj, _vd, fi, tets, ft, tf, bg) = tet_scene(
        20, 1, H, W)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    inv_mv = np.asarray(jnp.linalg.inv(jnp.asarray(mv_t)))
    inv_pj = np.asarray(jnp.linalg.inv(jnp.asarray(proj_t)))
    args = (v, f, vc, fo, mv_t, proj_t, inv_mv, inv_pj, fi, tets, ft, tf, bg)

    t0 = time.perf_counter()
    t = tet_args_from_numpy(*args, device="cpu")
    _c, _d, _a, sp = pt.render_tet_forward(*t, H, W, 0)
    port = {k: sp[k].numpy().reshape(-1) for k in INT_KEYS}
    t1 = time.perf_counter()
    _c, _d, _a, sj = jt._render_tet_forward(
        *[jnp.asarray(x) for x in args], H, W, 0, 512)
    ref = {k: np.asarray(sj[k]).reshape(-1) for k in INT_KEYS}
    t2 = time.perf_counter()
    print(f"port {t1 - t0:.1f} s, JAX {t2 - t1:.1f} s (CPU)")
    for name, r in (("port", port), ("JAX", ref)):
        print(f"{name}: first-hit pixels {int((r['first_face'] >= 0).sum())}"
              f", active {int(r['is_active'].sum())}, longest walk "
              f"{int(r['n_contrib'].max())}, blend events "
              f"{int(r['n_contrib'].sum())}")
    for k in INT_KEYS:
        print(f"  {k}: {int((port[k] != ref[k]).sum())} pixels differ")

    m = pt.march_tables(t[0], t[1], t[9], t[11], t[10], t[2], t[3], t[8])
    rd = pt.generate_rays(t[6], t[7], W, H, norm_eps_mode="tet")[1]
    rd = rd.reshape(-1, 3).numpy().astype(np.float64)
    o = inv_mv[0, 3, :3].astype(np.float64)
    verts = v.astype(np.float64)
    bad = np.nonzero((port["first_face"] != ref["first_face"])
                     | (port["is_active"] != ref["is_active"])
                     | (port["n_contrib"] != ref["n_contrib"]))[0]
    for pix in bad:
        d = rd[pix]
        fp, fj = int(port["first_face"][pix]), int(ref["first_face"][pix])
        head = (f"pixel {pix}: n_contrib {port['n_contrib'][pix]} (JAX "
                f"{ref['n_contrib'][pix]}), active {bool(port['is_active'][pix])}"
                f" (JAX {bool(ref['is_active'][pix])})")
        if fp != fj:
            ts = []
            for face in (fp, fj):
                p0, p1, p2 = verts[f[face]]
                e1, e2, tv = p1 - p0, p2 - p0, o - p0
                pv, qv = np.cross(d, e2), np.cross(tv, e1)
                ts.append(qv @ e2 / (pv @ e1))
            ulp = float(np.spacing(np.float32(ts[0])))
            print(f"{head}; first face {fp} (JAX {fj}): f64 t {ts[0]:.9f} vs "
                  f"{ts[1]:.9f}, {abs(ts[0] - ts[1]) / ulp:.1f} f32 ulps "
                  f"apart")
            continue
        ct = int(pt.start_tets_plain(
            torch.tensor([fp], dtype=torch.int32),
            torch.from_numpy(d[None].astype(np.float32)), m["geo"],
            m["sign"], t[10], t[11])[0])
        steps = int(min(port["n_contrib"][pix], ref["n_contrib"][pix]))
        margin, step, slot = walk_margins(fp, ct, d, o, m, steps)
        print(f"{head}; nearest decision: step {step} slot {slot}, f64 "
              f"margin {margin:.2e}")

    # the API inverts the matrices with torch.linalg.inv, whose projection
    # inverse differs from jnp.linalg.inv's in the last bit of a few entries
    t_inv = list(t)
    t_inv[6], t_inv[7] = torch.linalg.inv(t[4]), torch.linalg.inv(t[5])
    _c, _d, _a, sinv = pt.render_tet_forward(*t_inv, H, W, 0)
    print(f"port with torch.linalg.inv's inverses: active "
          f"{int(sinv['is_active'].sum())}, blend events "
          f"{int(sinv['n_contrib'].sum())}")

    exp, log = torch.exp, torch.log
    torch.exp = lambda x: exp(x.double()).float()
    torch.log = lambda x: log(x.double()).float()
    try:
        _c, _d, _a, s64 = pt.render_tet_forward(*t, H, W, 0)
    finally:
        torch.exp, torch.log = exp, log
    nc64 = s64["n_contrib"].numpy().reshape(-1)
    act64 = s64["is_active"].numpy().reshape(-1)
    moved = np.nonzero((nc64 != port["n_contrib"])
                       | (act64 != port["is_active"]))[0]
    print(f"port with f64 exp/log: active {int(act64.sum())}, blend events "
          f"{int(nc64.sum())}; {len(moved)} pixels move")
    log_teps = float(np.log(np.float32(1e-4)))
    for pix in moved:
        lts = [sv[k].numpy().reshape(-1)[pix] for sv in (sp, s64)
               for k in ("final_log_T", "final_prev_log_T")]
        near = min(abs(x - log_teps) for x in lts)
        print(f"pixel {pix}: n_contrib {port['n_contrib'][pix]} -> "
              f"{nc64[pix]}, active {bool(port['is_active'][pix])} -> "
              f"{bool(act64[pix])}; log T within {near:.2e} of log(T_EPS)")


if __name__ == "__main__":
    main()
