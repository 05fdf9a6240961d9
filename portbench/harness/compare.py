"""The numbers that decide ``correct``, each against its limit.

Training (the first ``reference_steps`` steps, which set-up drives through
the window's own step and feed, on rows that all differ: the eager step,
the capture and a replay). The reference follows the program step by
step from the program's own state (``refside.follow``): a free-running
reference parts from the program by round-off after the first update,
which flips the fixed-point coverage of pixels on triangle edges and the
ends of tet walks, so its later steps' gaps swing from seed to seed
(``PERF.md``). Step 1 starts from the scene's own parameters. Each number
is the worst over the steps:

- ``loss_gap``: |program loss - reference loss| / |reference loss|;
- ``grad_gap``: by the worst leaf, the gap between the norms of the
  step's gradient as the optimiser got it (the program's from Adam's
  first moments) and the reference's, over the larger of that leaf's
  reference norm and the median leaf's;
- ``change_gap``: the same for the step's change of the parameters
  against the reference's Adam update of the program's state, leaving out
  leaves whose reference gradient norm is under a thousandth of the
  median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import statistics
import sys

import torch

MOVED = 1e-3  # a leaf moves when its gradient norm is this share of the median


def _norms(xs):
    return [float(torch.linalg.vector_norm(x.double())) for x in xs]


def leaf_gap(prog, ref, keep=None) -> float:
    """The worst leaf's |norm(program) - norm(reference)| over the larger of
    that leaf's reference norm and the median leaf's."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn)
    gaps = [abs(p - r) / max(r, med, 1e-30)
            for i, (p, r) in enumerate(zip(pn, rn))
            if keep is None or keep[i]]
    return max(gaps) if gaps else 0.0


def train_numbers(got: dict, ref: dict, start: list, beta1: float) -> dict:
    """``got``: the program's trajectory ({"losses", "params", "m", "v"},
    as ``refside.train`` returns one); ``ref``: ``refside.follow`` of it;
    ``start``: the scene's own parameters. The program's gradient of step
    t is worked out from its first moments, (m_t - beta1 m_(t-1)) / (1 -
    beta1)."""
    n = len(ref["losses"])
    if len(got["losses"]) != n:
        raise ValueError("the program and the reference ran different steps")
    loss = [abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
            for a, b in zip(got["losses"], ref["losses"])]
    grad, change = [], []
    for t in range(1, n + 1):
        g = [(a - beta1 * b) / (1.0 - beta1)
             for a, b in zip(got["m"][t], got["m"][t - 1])]
        grad.append(leaf_gap(g, ref["grads"][t - 1]))
        before = start if t == 1 else got["params"][t - 1]
        gn = _norms(ref["grads"][t - 1])
        med = statistics.median(gn)
        change.append(leaf_gap(
            [a - b for a, b in zip(got["params"][t], before)],
            [a - b for a, b in zip(ref["params"][t - 1], before)],
            [x >= MOVED * med for x in gn]))
    sys.stderr.write(f"portbench: by step: loss {loss} grad {grad} "
                     f"change {change}\n")
    sys.stderr.flush()
    return {"loss_gap": max(loss), "grad_gap": max(grad),
            "change_gap": max(change)}


def train_followed(cfg, scene, traj, step_views) -> dict:
    """The numbers of a trajectory (the program's, or one put in its place;
    as ``refside.train`` returns one) against the float32 reference that
    follows it (``refside.follow``)."""
    from . import refside
    from .scenes import leaves

    ref = refside.follow(cfg, scene, traj, step_views)
    return train_numbers(traj, ref, [x.detach() for x in leaves(scene)],
                         cfg["optimizer"]["betas"][0])


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    out = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v == v and v <= limits[k] for k, v in numbers.items())
    return ok, out
