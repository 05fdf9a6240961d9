"""dmesh_renderer_tpu_torch: the tri renderer's forward in PyTorch and CUDA.

A port of ``dmesh_renderer_tpu`` (JAX, TPU) to PyTorch on an NVIDIA H100,
slice by slice. This package imports torch and NumPy, never JAX, and nothing
of the JAX package. It holds the tri renderer's forward: the dense oracle
and the tile-binned path, whose compositing is the hand-written CUDA kernel
``csrc/tri_fwd.cu``.
"""

from .api import TriRenderSettings, TriRenderer, render_tri

__all__ = ["TriRenderSettings", "TriRenderer", "render_tri"]
