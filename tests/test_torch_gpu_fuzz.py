"""The parity fuzz harnesses on the card: a few seeds of each default
sweep (tri: K1, K2 and ``seg_sum`` against the dense oracle; tet: K3, K4
and K5 against the f64 spec, with both first hits) and one ``--big``
config of each (tri lists past the 32-slot rounds; tet held to the port on
the CPU).

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_fuzz.py
"""

import pytest
import torch

from dmesh_renderer_tpu_torch.tools import fuzz_tet_parity as ftet
from dmesh_renderer_tpu_torch.tools import fuzz_tri_parity as ftri

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("harness, seeds, big", [
    ("tri", range(1000, 1004), False),
    ("tri", range(1003, 1004), True),
    ("tet", range(2000, 2003), False),
    ("tet", range(2000, 2001), True),
])
def test_sweep_clean_and_kernels_launched(harness, seeds, big, cuda):
    mod = ftri if harness == "tri" else ftet
    results, launched = mod.sweep(seeds, cuda, big)
    assert [e for _label, e in results if e] == []
    assert all(launched[k] > 0 for k in mod.KERNELS), launched


def test_big_tri_config_runs_past_a_round(cuda):
    """The ``--big`` tri config of seed 1003 (1,024 triangles at 96x80)
    holds tile lists longer than two of K1's 32-slot rounds."""
    from dmesh_renderer_tpu_torch.ops import binning, geometry

    args, h, w, label = ftri.make_config(1003, big=True)
    assert "F=1024 96x80" in label
    t = [torch.from_numpy(a).to(cuda) for a in args]
    ndc, img = geometry.project_verts(t[0], t[4], t[5], w, h)
    pre = geometry.preprocess_faces(ndc, img, t[1], w, h, 32, 32)
    keys = binning.emit_and_sort(pre, (w + 31) // 32, (h + 31) // 32, 1 << 20)
    assert int((keys.ends - keys.starts).max()) > 64
