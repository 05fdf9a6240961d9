"""dmesh_renderer_tpu_torch: the tri renderer in PyTorch and CUDA.

A port of ``dmesh_renderer_tpu`` (JAX, TPU) to PyTorch on an NVIDIA H100,
slice by slice. This package imports torch and NumPy, never JAX, and nothing
of the JAX package. It holds the tri renderer with its five gradients: the
dense oracle and the tile-binned path, whose compositing forward and
backward are the hand-written CUDA kernels ``csrc/tri_fwd.cu`` and
``csrc/tri_bwd.cu``, and the single-device train step of
``models/dmesh.py``.
"""

from .api import TriRenderSettings, TriRenderer, render_tri

__all__ = ["TriRenderSettings", "TriRenderer", "render_tri"]
