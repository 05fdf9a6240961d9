"""The system under test: the PyTorch and CUDA port, called through its
public entry points, and nothing else of it.

``TrainProgram`` builds the port's train step (``models.dmesh``'s
``make_train_step`` or ``make_tet_train_step``, the captured path on the
card) over a fresh copy of the scene's learnable tensors with a capturable
Adam.
"""

from __future__ import annotations

import torch

from .scenes import Scene, Views


def build_kernels() -> None:
    """Build every CUDA kernel of the port that is not built yet (into the
    checkout's ``dmesh_renderer_tpu_torch/_build/``)."""
    from dmesh_renderer_tpu_torch import kernels

    kernels.build()


class TrainProgram:
    """One train step of the port and its state, on ``scene``'s device."""

    def __init__(self, cfg: dict, scene: Scene, mark=lambda part: None):
        """``mark(part)`` is called as each part of the construction ends
        (set-up's split)."""
        from dmesh_renderer_tpu_torch.models import dmesh

        self.dmesh = dmesh
        self.cfg, self.scene = cfg, scene
        H, W = cfg["height"], cfg["width"]
        opt = cfg["optimizer"]
        dev = scene.verts.device
        capturable = dev.type == "cuda"

        def adam(params):
            return torch.optim.Adam(params, lr=opt["lr"],
                                    betas=tuple(opt["betas"]), eps=opt["eps"],
                                    capturable=capturable)

        if scene.renderer == "tri":
            leaves = dmesh.TriScene(*(x.detach().clone().requires_grad_(True)
                                      for x in (scene.verts, scene.vcolor,
                                                scene.fopac)))
            self.step = dmesh.make_train_step(scene.faces, scene.bg, H, W)
        else:
            leaves = dmesh.TetScene(*(x.detach().clone().requires_grad_(True)
                                      for x in (scene.vcolor, scene.fopac)))
            geom = dmesh.TetGeometry(scene.verts, scene.faces, scene.tets,
                                     scene.face_tets, scene.tet_faces)
            self.step = dmesh.make_tet_train_step(
                geom, scene.bg, H, W, seed=int(cfg["ray_seed"]))
        mark("step")
        self.state = dmesh.init_train_state(leaves, adam)
        self.start = [p.detach().clone() for p in leaves]
        mark("optimizer")

    def batch(self, views: Views):
        """The port's batch type for ``views`` (the inverse matrices made by
        the port's public helper, as a user makes them)."""
        from dmesh_renderer_tpu_torch.api import _inverses

        inv_mv, inv_proj = _inverses(views.mv_t, views.proj_t)
        if self.scene.renderer == "tri":
            return self.dmesh.ViewBatch(views.mv_t, views.proj_t, inv_mv,
                                        inv_proj, views.vdepth, views.finten,
                                        views.target)
        return self.dmesh.TetViewBatch(views.mv_t, views.proj_t, inv_mv,
                                       inv_proj, views.finten, views.target)

    def __call__(self, batch) -> torch.Tensor:
        """One optimiser step; returns the step's loss (a device scalar)."""
        self.state, loss = self.step(self.state, batch)
        return loss

    def reset(self) -> None:
        """The scene's parameters and the optimiser's state back to their
        start, in place (no host sync; a captured step keeps replaying):
        the window repeats the same steps of training (``traffic``'s
        ``reset_every``)."""
        opt = self.state.opt_state
        with torch.no_grad():
            for p, p0 in zip(self.state.scene, self.start):
                p.copy_(p0)
                for x in opt.state.get(p, {}).values():
                    if isinstance(x, torch.Tensor):
                        x.zero_()

    def params(self) -> list:
        return [p.detach().clone() for p in self.state.scene]

    def moments(self) -> tuple[list, list]:
        """Adam's first and second moments of each leaf (zeros before the
        optimiser's first step)."""
        opt = self.state.opt_state
        out = ([], [])
        for p in self.state.scene:
            st = opt.state.get(p, {})
            for k, key in enumerate(("exp_avg", "exp_avg_sq")):
                x = st.get(key)
                out[k].append(torch.zeros_like(p.detach()) if x is None
                              else x.detach().clone())
        return out

