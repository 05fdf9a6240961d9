"""The port's example loops (``examples/port_optimize_*.py``) on the CPU.

Each example's ``main`` runs a few steps (``--device cpu --steps 4``): the
loss falls, and the step resumed from the midpoint checkpoint (taken after
step 2) repeats step 3 of the uninterrupted run bit for bit. The tri
example runs on 2 ranks (``--ranks 2``: two processes, one view each).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import port_optimize_tet  # noqa: E402
import port_optimize_triangles  # noqa: E402

STEPS = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these small steps gain nothing from more, and
    beside the suite's parallel workers more only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("example, ranks", [
    (port_optimize_triangles, 2), (port_optimize_tet, 1)],
    ids=["triangles_2_ranks", "tet_1_rank"])
def test_example_runs_and_resumes(tmp_path, example, ranks):
    out = example.main(["--device", "cpu", "--ranks", str(ranks),
                        "--steps", str(STEPS), "--out-dir", str(tmp_path)])
    losses = out["losses"]
    assert len(losses) == STEPS and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert out["resumed_loss"] == losses[STEPS // 2 + 1]
    assert Path(out["checkpoint"]).parent == tmp_path
