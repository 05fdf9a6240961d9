"""dmesh_renderer_tpu_torch: the renderers in PyTorch and CUDA.

A port of ``dmesh_renderer_tpu`` (JAX, TPU) to PyTorch on an NVIDIA H100,
slice by slice. This package imports torch and NumPy, never JAX, and nothing
of the JAX package. It holds the tri renderer with its five gradients: the
dense oracle and the tile-binned path, whose compositing forward and
backward are the hand-written CUDA kernels ``csrc/tri_fwd.cu`` and
``csrc/tri_bwd.cu``, and the single-device train step of
``models/dmesh.py``; and the tet renderer's forward, whose binned first hit
and ray march are the kernels of ``csrc/tet_fwd.cu``.
"""

from .api import (
    TetRenderSettings,
    TetRenderer,
    TriRenderSettings,
    TriRenderer,
    render_tet,
    render_tri,
)

__all__ = ["TetRenderSettings", "TetRenderer", "TriRenderSettings",
           "TriRenderer", "render_tet", "render_tri"]
