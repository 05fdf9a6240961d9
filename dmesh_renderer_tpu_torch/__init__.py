"""dmesh_renderer_tpu_torch: the renderers in PyTorch and CUDA.

A port of ``dmesh_renderer_tpu`` (JAX, TPU) to PyTorch on an NVIDIA H100,
slice by slice. This package imports torch and NumPy, never JAX, and nothing
of the JAX package. It holds the tri renderer with its five gradients: the
dense oracle and the tile-binned path, whose compositing forward and
backward are the hand-written CUDA kernels ``csrc/tri_fwd.cu`` and
``csrc/tri_bwd.cu``; the tet renderer with the gradients of vertex colours
and face opacities, whose binned first hit and ray march are the kernels of
``csrc/tet_fwd.cu`` and whose backward march is ``csrc/tet_bwd.cu``; and
the single-device train steps of both (``models/dmesh.py``).
"""

from .api import (
    TetRenderSettings,
    TetRenderer,
    TriRenderSettings,
    TriRenderer,
    render_tet,
    render_tri,
)
from .models.dmesh import (
    TetGeometry,
    TetScene,
    TetViewBatch,
    TrainState,
    TriScene,
    ViewBatch,
    init_tet_train_state,
    init_train_state,
    make_tet_train_loop,
    make_tet_train_step,
    make_train_loop,
    make_train_step,
)
from .ops.binning import recommended_key_capacity
from .utils.connectivity import build_tet_connectivity

__version__ = "0.1.0"

__all__ = ["TetGeometry", "TetRenderSettings", "TetRenderer", "TetScene",
           "TetViewBatch", "TrainState", "TriRenderSettings", "TriRenderer",
           "TriScene", "ViewBatch", "__version__", "build_tet_connectivity",
           "init_tet_train_state", "init_train_state", "make_tet_train_loop",
           "make_tet_train_step", "make_train_loop", "make_train_step",
           "recommended_key_capacity", "render_tet", "render_tri"]
