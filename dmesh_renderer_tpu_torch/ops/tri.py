"""Tri renderer dispatch: the dense oracle or the tile-binned path.

A port of the JAX package's ``ops/tri.py``, including its empty-geometry
behaviour. The strategy follows the face count and the device of the
inputs. Both strategies are differentiable; with no vertices the output is
a constant zero image whose gradients are zeros of the inputs' shapes.
"""

from __future__ import annotations

import torch

from .tri_oracle import render_tri_oracle

# Face counts above which the binned path is taken. On the CPU the binned
# composite is the plain torch loop, so the dense path stays preferable far
# longer (the JAX package's value, which the parity tests use). On the card
# the dense oracle, a Python loop over the faces, was slower than the binned
# path in fwd+bwd at every face count of chip_smoke.py's ladder, from 8
# faces up, at 64x64, 256x256 and 800x800 (NVIDIA H100): every scene with a
# face takes the binned path there.
BINNED_THRESHOLD_CPU = 4096
BINNED_THRESHOLD_GPU = 0


class _ConstantZeros(torch.autograd.Function):
    """A zero (color, depth) image on the inputs' device, with zero
    gradients for every differentiable input."""

    @staticmethod
    def forward(ctx, B, height, width, *inputs):
        ctx.like = [(x.shape, x.device) for x in inputs]
        dev = inputs[0].device
        return (torch.zeros((B, 3, height, width), dtype=torch.float32,
                            device=dev),
                torch.zeros((B, 1, height, width), dtype=torch.float32,
                            device=dev))

    @staticmethod
    def backward(ctx, _dc, _dd):
        return (None, None, None) + tuple(
            torch.zeros(s, dtype=torch.float32, device=d) for s, d in ctx.like)


def tri_strategy(n_verts: int, n_faces: int, device: torch.device,
                 force: str | None = None) -> str:
    """The path ``render_tri_auto`` takes: "empty" (no vertices), "oracle"
    or "binned"."""
    if force not in (None, "oracle", "binned"):
        raise ValueError(
            f"force must be None, 'oracle' or 'binned', got {force!r}")
    if n_verts == 0:
        return "empty"
    if n_faces == 0:
        # no faces: every pixel blends nothing -> bg and depth 1; the
        # binned path needs a face, so this always takes the oracle
        return "oracle"
    threshold = (BINNED_THRESHOLD_CPU if device.type == "cpu"
                 else BINNED_THRESHOLD_GPU)
    return force or ("binned" if n_faces > threshold else "oracle")


def render_tri_auto(verts, faces, verts_color, faces_opacity, mv_t, proj_t,
                    inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg,
                    height: int, width: int, *, force: str | None = None,
                    kcap: int | None = None, with_aux: bool = False,
                    run_cap: int | None = None, warn_overflow: bool = True,
                    with_runs: bool = False):
    """Render triangles; the strategy follows the face count. Gradients
    reach verts, verts_color, faces_opacity, verts_depth and faces_intense.

    force: "oracle" or "binned" overrides the choice. kcap/run_cap: the
    binned path's capacities (None: heuristics). with_aux: also return
    ``(overflow, num_rendered)``; the oracle has no capacity and reports
    ``(False, -1)``. warn_overflow: the binned path reads the overflow flag
    once after its forward and warns (``render_tri_binned``). with_runs: the
    binned path's aux also carries its run count (``render_tri_binned``)."""
    dev = verts.device
    B = mv_t.shape[0]
    strategy = tri_strategy(verts.shape[0], faces.shape[0], dev, force)
    if strategy == "empty":
        # with no vertices the reference returns its zero-initialised
        # outputs as they are -- not background-filled
        color, depth = _ConstantZeros.apply(
            B, height, width, verts, verts_color, faces_opacity, verts_depth,
            faces_intense)
        if with_aux:
            return color, depth, (torch.tensor(False, device=dev),
                                  torch.tensor(0, device=dev))
        return color, depth
    if strategy == "binned":
        from .tri_binned import render_tri_binned

        return render_tri_binned(
            verts, faces, verts_color, faces_opacity, mv_t, proj_t,
            inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg,
            height, width, kcap, with_aux, run_cap, warn_overflow, with_runs)

    out = render_tri_oracle(
        verts, faces, verts_color, faces_opacity, mv_t, proj_t,
        inv_mv_t, inv_proj_t, verts_depth, faces_intense, bg, height, width)
    if with_aux:
        return out + ((torch.tensor(False, device=dev),
                       torch.tensor(-1, device=dev)),)
    return out
