"""The tet forward's binned path stage by stage, and the card against the
CPU on it.

``stages`` splits ``ops.tet.render_tet_forward``'s binned path into one
function per stage, so that each can be timed, run with another first hit,
or compared. ``CASES`` and ``scene`` are the small scenes on which the GPU
tests and ``chip_smoke.py`` hold the card to the CPU. ``card_vs_cpu``
runs every stage on both devices from the same inputs and names each
output that is not bit-equal: only the march tables' log column and what
K4 derives from it through exp may differ (``TRANSCENDENTAL``), since the
two devices' ``log`` and ``exp`` round apart in the last bit.

The scenes' cameras come from the repository's ``tests/scenes.py``
(``ring_cameras``, NumPy only), loaded by path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import binning, geometry, rays
from ..ops import tet as pt
from ..ops import tet_first_hit as pfh
from ..utils.connectivity import build_tet_connectivity, freudenthal_grid
from .fuzz_common import load_test_module

# (grid n, jitter, grid seed, views, ring radius, H, W, ray seed): the
# adversarial golden's scene, an image that is no multiple of 16, cameras
# outside the mesh without jitter, and a ragged image whose tile lists
# (180-1,482 slots) K3 walks for a few of its 32-slot rounds
CASES = {
    "adversarial": (6, 0.14, 21, 2, 1.1, 48, 48, 17),
    "odd_37x50": (4, 0.12, 3, 1, 0.9, 37, 50, 5),
    "outside": (5, 0.1, 8, 2, 3.0, 64, 64, 0),
    "ragged_100x72": (8, 0.1, 8, 2, 2.0, 100, 72, 0),
}
# outputs that may differ between the devices: the log column and K4's
# exp-derived values, and the image assembled from them
TRANSCENDENTAL = ("shade log column", "K4: K4 C ", "K4: K4 D",
                  "K4: K4 log T", "assembly: image colour",
                  "assembly: image depth")


def scene(case):
    """The scene ``case`` of ``CASES`` as NumPy arrays: the 13 functional
    arguments of ``render_tet_forward`` (transposed matrices, inverses by
    NumPy), H, W and the ray seed."""
    n, jit, gseed, b, radius, h, w, seed = CASES[case]
    verts, tets = freudenthal_grid(n, jitter=jit, seed=gseed)
    faces, face_tets, tet_faces = build_tet_connectivity(tets)
    rng = np.random.RandomState(33)
    vcolor = rng.rand(verts.shape[0], 3).astype(np.float32)
    fopacity = rng.uniform(0.05, 0.95, faces.shape[0]).astype(np.float32)
    fopacity[rng.randint(0, faces.shape[0], faces.shape[0] // 10)] = 1.0
    fintense = rng.uniform(0.5, 1.0, (b, faces.shape[0])).astype(np.float32)
    mv, proj = load_test_module("scenes").ring_cameras(b, radius=radius)
    mv_t = np.swapaxes(mv, 1, 2).copy()
    proj_t = np.swapaxes(proj, 1, 2).copy()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    args = (verts, faces, vcolor, fopacity, mv_t, proj_t,
            np.linalg.inv(mv_t), np.linalg.inv(proj_t), fintense, tets,
            face_tets, tet_faces, bg)
    return args, h, w, seed


def stages(fargs, h, w, seed=0, kcap=None):
    """The binned forward's stages (the sequence of
    ``ops.tet.render_tet_forward``), one function each, on the device of
    ``fargs``: (the sequence of (name, function), the dict of what they
    computed, and functions giving the inputs of K3 and K4). ``kcap``:
    the key capacity (None: ``default_key_capacity`` at 5 tiles a face)."""
    (verts, faces, vc, fo, mv_t, proj_t, inv_mv_t, inv_proj_t, fi, tets,
     face_tets, tet_faces, bg) = fargs
    B, F = mv_t.shape[0], faces.shape[0]
    M = B * h * w
    gx, gy = (w + 31) // 32, (h + 31) // 32
    if kcap is None:
        kcap = binning.default_key_capacity(B, F, avg_tiles_per_face=5)
    cam_o = inv_mv_t[:, 3, :3].contiguous()
    st = {}

    def project():
        ndc, img = geometry.project_verts(verts, mv_t, proj_t, w, h)
        st["pre"] = geometry.preprocess_faces(ndc, img, faces, w, h, 32, 32)

    def binning_():
        st["keys"] = binning.emit_and_sort(st["pre"], gx, gy, kcap,
                                           sort_by="min_depth")

    def table():
        st["table"] = pfh.build_first_hit_table(
            verts, faces, cam_o, st["pre"]["min_depth"],
            st["pre"]["max_depth"])[st["keys"].sigma]

    def rays_():
        st["rd"] = rays.generate_rays(inv_mv_t, inv_proj_t, w, h,
                                      norm_eps_mode="tet",
                                      jitter_seed=seed or None)[1]

    def fh_inputs():
        k = st["keys"]
        return (k.starts, k.ends, k.slot_face, st["table"], st["rd"], B, h, w)

    def k3():
        st["fh"] = pfh.first_hit(*fh_inputs())

    def tables():
        st["march"] = m = pt.march_tables(verts, faces, tets, tet_faces,
                                          face_tets, vc, fo, fi)
        st["ff"] = st["fh"][0].reshape(M)
        st["first_tet"], st["zw"], st["tuv"] = pt.ray_start(
            st["ff"], st["rd"].reshape(M, 3), *st["fh"][1:4], cam_o, mv_t,
            proj_t, m["geo"], m["sign"], face_tets, tet_faces)

    def march_inputs():
        m = st["march"]
        return (st["rd"].reshape(M, 3), cam_o, st["zw"], st["ff"],
                st["first_tet"], st["tuv"], m["tet_geo"], m["tet_nrm"],
                m["tet_ids"], m["shade"], h, w)

    def k4():
        st["out"] = pt.fwd_march(*march_inputs())

    def assemble():
        out_f, out_i = st["out"]
        act = out_i[3] != 0
        final_T = torch.exp(out_f[4])
        col = [torch.where(act, out_f[c] + final_T * bg[c], bg[c])
               for c in range(3)]
        st["image"] = (
            torch.stack(col).reshape(3, B, h, w).transpose(0, 1).contiguous(),
            torch.where(act, out_f[3] + final_T * 1.0, 1.0).reshape(
                B, 1, h, w), act.reshape(B, h, w))

    seq = [("projection+preprocess", project), ("binning", binning_),
           ("first-hit table", table), ("rays", rays_), ("K3", k3),
           ("march tables+start tet", tables), ("K4", k4),
           ("assembly", assemble)]
    return seq, st, fh_inputs, march_inputs


def differ(a, b):
    """(bit-equal, how far apart): the largest absolute difference of
    float tensors, the count of differing elements of integer and bool
    ones."""
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    if a.shape != b.shape:
        return False, float("inf")
    if torch.equal(a, b):
        return True, 0
    if a.is_floating_point():
        return False, float((a.double() - b.double()).abs().nan_to_num(
            float("inf")).max())
    return False, int((a != b).sum())


def _items(st, stage):
    """What a stage of ``stages`` produced, as (name, tensor)."""
    if stage == "projection+preprocess":
        items = []
        for k, v in st["pre"].items():  # the edge rows are tuples
            if torch.is_tensor(v):
                items.append((f"pre.{k}", v))
            else:
                items += [(f"pre.{k}[{i}]", x) for i, x in enumerate(v)]
        return items
    if stage == "binning":
        return [(f"keys.{k}", getattr(st["keys"], k))
                for k in ("starts", "ends", "slot_face", "sigma", "total",
                          "overflow")]
    if stage == "first-hit table":
        return [("first-hit table", st["table"])]
    if stage == "rays":
        return [("rays", st["rd"])]
    if stage == "K3":
        return [(f"K3 {k}", x) for k, x in zip(
            ("first_face", "t", "u", "v", "walked"), st["fh"])]
    if stage == "march tables+start tet":
        m = st["march"]
        cols = [c for c in range(12) if c != 10]
        return ([(k, m[k]) for k in ("tet_geo", "tet_nrm", "tet_ids", "geo",
                                     "sign")]
                + [("shade but its log column", m["shade"][:, cols]),
                   ("shade log column (log(1 - alpha))", m["shade"][:, 10]),
                   ("start tets", st["first_tet"]),
                   ("projective z/w", st["zw"]), ("first hit t/u/v",
                                                  st["tuv"])])
    if stage == "K4":
        out_f, out_i = st["out"]
        return ([(f"K4 {k}", out_f[i]) for i, k in enumerate(
            ("C r", "C g", "C b", "D", "log T", "log T before the last "
             "blend"))]
                + [(f"K4 {k}", out_i[i]) for i, k in enumerate(
                    ("last face", "last tet", "n_contrib", "active"))])
    return [(f"image {k}", x) for k, x in zip(("colour", "depth", "active"),
                                              st["image"])]


def card_vs_cpu(dev, args, h, w, seed):
    """Every stage of the binned forward on ``dev`` and on the CPU from the
    same NumPy ``args`` (as ``scene`` gives them), in order, each output
    compared bit for bit. Returns (the first output that is not
    bit-equal, or None; every such output as (name, how far apart))."""
    from ..convert import tet_args_from_numpy

    cpu = torch.device("cpu")
    run = {d: stages(tet_args_from_numpy(*args, device=d), h, w, seed)
           for d in (dev, cpu)}
    differing = []
    for (stage, fn_d), (_s, fn_c) in zip(run[dev][0], run[cpu][0]):
        fn_d()
        fn_c()
        for (item, a), (_i, b) in zip(_items(run[dev][1], stage),
                                      _items(run[cpu][1], stage)):
            eq, far = differ(a, b)
            if not eq:
                differing.append((f"{stage}: {item}", far))
    return (differing[0][0] if differing else None), differing


def not_transcendental(differing):
    """The names among ``differing`` (as ``card_vs_cpu`` gives it) that no
    transcendental explains: each is a fault."""
    return [n for n, _f in differing
            if not any(t in n for t in TRANSCENDENTAL)]
