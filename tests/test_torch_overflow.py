"""The torch port warns when the tile binning's key capacity drops (face,
tile) pairs, as the JAX package does (``binning.overflow_warning``), on
CPU: ``TriRenderer`` on its binned path and ``TetRenderer`` with the binned
first hit, each with a capacity too small for its scene, warn in the JAX
package's wording; at the default capacity neither warns. The overflow
stays reported as data (``return_aux``) beside the warning.
"""

import warnings

import numpy as np
import pytest
import torch

from dmesh_renderer_tpu_torch import (
    TetRenderSettings,
    TetRenderer,
    TriRenderSettings,
    TriRenderer,
)
from dmesh_renderer_tpu_torch.ops import tet as pt
from dmesh_renderer_tpu_torch.ops import tri as ptri
from dmesh_renderer_tpu_torch.utils import scenes

H = W = 48
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _tri(monkeypatch, key_capacity):
    monkeypatch.setattr(ptri, "BINNED_THRESHOLD_CPU", 0)
    args = [torch.from_numpy(x) for x in scenes.tri_scene(64, 2, H, W, 5)]
    r = TriRenderer(TriRenderSettings(H, W, BG, key_capacity), device="cpu")
    return r(*args, return_aux=True)


def _tet(monkeypatch, key_capacity):
    monkeypatch.setattr(pt, "BINNED_FIRST_HIT_THRESHOLD", 1)
    *inputs, bg = scenes.tet_scene(3, 1, H, W)
    r = TetRenderer(TetRenderSettings(H, W, bg, key_capacity=key_capacity),
                    device="cpu")
    return r(*[torch.from_numpy(np.ascontiguousarray(x)) for x in inputs],
             return_aux=True)


@pytest.mark.parametrize("render, context", [
    (_tri, "render_tri_binned; raise TriRenderSettings.key_capacity"),
    (_tet, "tet first hit; a dropped face cannot be hit"),
])
def test_overflow_warns(render, context, monkeypatch):
    with pytest.warns(UserWarning, match="key capacity") as rec:
        *_out, (overflow, total) = render(monkeypatch, 16)
    assert bool(overflow) and int(total) > 16
    msg = str(rec[0].message)
    assert context in msg
    assert (f"tile-binning key capacity overflow ({int(total)} (face, tile) "
            f"pairs emitted > capacity 16)") in msg
    assert "Raise the key capacity" in msg


@pytest.mark.parametrize("render", [_tri, _tet])
def test_default_capacity_is_silent(render, monkeypatch):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        *_out, (overflow, total) = render(monkeypatch, None)
    assert not bool(overflow) and int(total) > 16
