"""Where the port's tet gradients part from the adversarial golden: a
diagnostic, not a test (about 10 s on the CPU).

    JAX_PLATFORMS=cpu python tests/tet_bwd_precision.py

The port's backward (the plain version of K5 and the record reduce) runs on
the adversarial golden's scene (``test_golden_tet_adversarial``) with JAX's
inverse matrices and ``test_tet_spec``'s upstream gradients; so does a
float64 copy of the same re-walk (``ops/tet.py``'s source with every float32
buffer made float64 and the exact root), fed the same float32 inputs: the
forward's state, rays and march tables. For the faces where the port's
``faces_opacity`` gradient is furthest from the golden's, it prints the
port's records summed exactly, the float64 re-walk's, the golden's value,
and the gaps of both to the float64 one.
"""

import os
import sys
import types

import numpy as np
import jax.numpy as jnp
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "..")]

import test_golden_tet_adversarial as tga  # noqa: E402
from dmesh_renderer_tpu_torch.convert import tet_args_from_numpy  # noqa: E402
from dmesh_renderer_tpu_torch.ops import tet as pt  # noqa: E402


def float64_tet_module():
    """``ops/tet.py`` with float64 buffers and the exact square root."""
    src = open(pt.__file__).read()
    src = src.replace("from __future__ import annotations", "")
    # the relative imports as absolute ones (the package's, then ops')
    src = src.replace("from ..", "from dmesh_renderer_tpu_torch.")
    src = src.replace("from .", "from dmesh_renderer_tpu_torch.ops.")
    src = src.replace("dtype=torch.float32", "dtype=torch.float64")
    src = src.replace("norm = sqrt_rn(", "norm = torch.sqrt(")
    mod = types.ModuleType("tet_float64")
    exec(compile(src, "tet_float64", "exec"), mod.__dict__)
    return mod


def main():
    torch.set_num_threads(1)
    sc = tga._scene()
    H, W = tga.H, tga.W
    (verts, faces, vc, fo, mv_t, proj_t, fi, tets, ft, tf, bg) = sc
    inv = [np.asarray(jnp.linalg.inv(jnp.asarray(m))) for m in (mv_t, proj_t)]
    t = tet_args_from_numpy(verts, faces, vc, fo, mv_t, proj_t, *inv, fi,
                            tets, ft, tf, bg, device="cpu")
    rng = np.random.RandomState(5)
    wc = torch.from_numpy(rng.randn(tga.B, 3, H, W).astype(np.float32))
    wd = torch.from_numpy(rng.randn(tga.B, 1, H, W).astype(np.float32))
    _c, _d, _a, saved = pt.render_tet_forward(*t, H, W, tga.SEED)
    m = saved["march"]
    ray_i, ray_f, off, n, total, _ovf = pt.bwd_start_state(saved, t[10], wc,
                                                           wd, t[12])
    keys, rec, bad = pt.bwd_march_plain(
        saved["ray_d"], saved["cam_o"], saved["zw"], ray_i, ray_f, off, n,
        m["tet_geo"], m["tet_nrm"], m["tet_ids"], m["shade"], H * W)
    g_vc, g_fo = pt.reduce_tet_records(keys, rec, t[1], t[0].shape[0])

    t64 = float64_tet_module()
    d = lambda x: (x.double() if isinstance(x, torch.Tensor)
                   and x.is_floating_point() else x)
    s64 = {k: d(saved[k]) for k in pt._BWD_SAVED if k != "march"}
    s64["march"] = {k: d(v) for k, v in m.items()}
    ray_i2, ray_f2, off2, n2, total2, _ovf2 = t64.bwd_start_state(
        s64, t[10], d(wc), d(wd), d(t[12]))
    keys2, rec2, bad2 = t64.bwd_march_plain(
        d(saved["ray_d"]), d(saved["cam_o"]), d(saved["zw"]), ray_i2,
        ray_f2, off2, n2, d(m["tet_geo"]), d(m["tet_nrm"]), m["tet_ids"],
        d(m["shade"]), H * W)
    print(f"records {int(total)} (float64 re-walk {int(total2)}); "
          f"keys equal "
          f"{torch.equal(keys, keys2)}; re-walk mismatches {int(bad.sum())} "
          f"(float64 {int(bad2.sum())})")

    golden = dict(np.load(tga.GOLDEN))
    want = golden["g_fopacity"]
    err = np.abs(g_fo.numpy() - want)
    scale = max(1.0, float(np.abs(want).max()))
    want_vc = golden["g_vcolor"]
    err_vc = np.abs(g_vc.numpy() - want_vc).max() / max(
        1.0, float(np.abs(want_vc).max()))
    print(f"rel Linf to the golden: faces_opacity {err.max() / scale:.3g}, "
          f"verts_color {err_vc:.3g}")
    for f in np.argsort(-err)[:4]:
        sel, sel2 = keys == int(f), keys2 == int(f)
        exact = float(rec[sel, 9].double().sum())
        truth = float(rec2[sel2, 9].sum())
        print(f"face {f}: {int(sel.sum())} records, sum of |records| "
              f"{float(rec[sel, 9].abs().sum()):.6g}; port (float32 sum) "
              f"{float(g_fo[f]):.8g}, port records summed exactly "
              f"{exact:.8g}, float64 re-walk {truth:.8g}, golden "
              f"{float(want[f]):.8g}; port - float64 {exact - truth:.3g}, "
              f"golden - float64 {float(want[f]) - truth:.3g}")


if __name__ == "__main__":
    main()
