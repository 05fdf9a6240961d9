"""The control of every comparison: the plain reference put in the
program's place, its shading and blend one precision lower (bfloat16
under the configurations' float32), judged by the same numbers. A limit
stands between the program's readings and the control's: the control has
to come out as not correct. ``tests/test_portbench_control.py`` holds it at
a small size; ``calibrate.py`` reads it on the card at the cells' sizes.
"""

from __future__ import annotations

import torch

from . import compare, refside

CONTROL = torch.bfloat16


def train_numbers(cfg, scene, step_views) -> dict:
    """The control's numbers: the reference's steps in bfloat16 shading,
    free-running, against the float32 reference that follows them."""
    ctl = refside.train(cfg, scene, step_views, CONTROL)
    return compare.train_followed(cfg, scene, ctl, step_views)

