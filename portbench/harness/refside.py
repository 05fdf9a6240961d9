"""The reference side of every comparison: the plain renderers of
``reference/`` and a plain Adam, on the benchmark's own inputs.

Nothing here imports the program. ``shade`` is the dtype of the
renderers' shading and blend: float32 for the reference, bfloat16 for the
control (the reference put in the program's place one precision lower).
"""

from __future__ import annotations

import torch

from reference import tet as ref_tet
from reference import tri as ref_tri

from .scenes import Scene, Views


def render(cfg: dict, scene: Scene, views: Views, params=None,
           shade=torch.float32, counts=None):
    """(color, depth, alpha or active) of ``views``; ``params`` replaces the
    scene's learnable tensors (tri: verts, vcolor, fopac; tet: vcolor,
    fopac)."""
    H, W = cfg["height"], cfg["width"]
    if scene.renderer == "tri":
        verts, vcolor, fopac = params or (scene.verts, scene.vcolor,
                                          scene.fopac)
        return ref_tri.render(verts, scene.faces, vcolor, fopac, views.mv_t,
                              views.proj_t, views.vdepth, views.finten,
                              scene.bg, H, W, shade=shade, counts=counts)
    vcolor, fopac = params or (scene.vcolor, scene.fopac)
    return ref_tet.render(scene.verts, scene.faces, vcolor, fopac,
                          views.mv_t, views.proj_t, views.finten, scene.tets,
                          scene.face_tets, scene.tet_faces, scene.bg, H, W,
                          max_steps=int(cfg["max_steps"]), shade=shade,
                          counts=counts)


def loss_sums(cfg: dict, scene: Scene, params, views: Views,
              shade=torch.float32):
    """The loss's numerator and denominator over ``views`` (differentiable
    in ``params``): tri the squared error and the value count (the port's
    mean), tet the squared error over active pixels and 3 per active pixel
    (the masked mean)."""
    color, _depth, third = render(cfg, scene, views, params, shade)
    err = (color - views.target) ** 2
    if scene.renderer == "tri":
        return err.sum(), float(err.numel())
    m = third[:, None].to(err.dtype)
    return (m * err).sum(), float(m.sum()) * 3.0


def step_pieces(cfg, scene, params, views: Views, shade=torch.float32):
    """(loss numerator, count, gradients of the numerator) of one step over
    ``views``, view by view."""
    leaves = [p.detach().clone().requires_grad_(True) for p in params]
    sums, count = 0.0, 0.0
    for b in range(views.mv_t.shape[0]):
        s, c = loss_sums(cfg, scene, leaves, views.take([b]), shade)
        s.backward()
        sums += float(s.detach())
        count += c
    return sums, count, [p.grad.float() for p in leaves]


def local_mean(loss_sum, count, grads):
    """The step's loss and gradients as the mean over its own values."""
    denom = max(count, 1.0)
    return loss_sum / denom, [g / denom for g in grads]


def adam_update(opt: dict, p, m, v, g, t: int):
    """One plain Adam step (Kingma and Ba, bias-corrected) of one tensor
    from its state (m, v) after t - 1 steps: (new p, new m, new v)."""
    b1, b2 = opt["betas"]
    m = m * b1 + g * (1.0 - b1)
    v = v * b2 + g * g * (1.0 - b2)
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    return p - opt["lr"] * (m / c1) / ((v / c2).sqrt() + opt["eps"]), m, v


def train(cfg: dict, scene: Scene, step_views: list,
          shade=torch.float32) -> dict:
    """The plain train steps over ``step_views`` (one Views per step) from
    the scene's parameters, free-running: {"losses": [n], "params": [n + 1
    lists of leaves, the first the start], "m", "v": Adam's moments after
    each step, in the same way}. A step's loss and gradients are the mean
    over its own values."""
    from .scenes import leaves

    p = [x.detach().float() for x in leaves(scene)]
    out = {"losses": [], "params": [p], "m": [[torch.zeros_like(x)
                                                for x in p]],
           "v": [[torch.zeros_like(x) for x in p]]}
    for t, views in enumerate(step_views, start=1):
        loss, grads = local_mean(*step_pieces(cfg, scene, p, views, shade))
        new = [adam_update(cfg["optimizer"], *a, t) for a in
               zip(p, out["m"][-1], out["v"][-1], grads)]
        p = [x[0] for x in new]
        out["losses"].append(loss)
        out["params"].append(p)
        out["m"].append([x[1] for x in new])
        out["v"].append([x[2] for x in new])
    return out


def follow(cfg: dict, scene: Scene, got: dict, step_views: list,
           shade=torch.float32) -> dict:
    """The reference step by step from the program's own state: step t's
    loss and gradients at the program's parameters after step t - 1 (step
    1 at the scene's own, the start), and the reference's Adam update of
    the program's state (moments after step t - 1) by those gradients.
    ``got`` is a trajectory as ``train`` returns it. Returns {"losses",
    "grads", "params": the updated parameters of each step}."""
    from .scenes import leaves

    out = {"losses": [], "grads": [], "params": []}
    start = [x.detach().float() for x in leaves(scene)]
    zeros = [torch.zeros_like(x) for x in start]
    for t, views in enumerate(step_views, start=1):
        p = start if t == 1 else [x.float() for x in got["params"][t - 1]]
        m = zeros if t == 1 else got["m"][t - 1]
        v = zeros if t == 1 else got["v"][t - 1]
        loss, grads = local_mean(*step_pieces(cfg, scene, p, views, shade))
        out["losses"].append(loss)
        out["grads"].append(grads)
        out["params"].append([adam_update(cfg["optimizer"], *a, t)[0]
                              for a in zip(p, m, v, grads)])
    return out
