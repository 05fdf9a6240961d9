"""The view mesh over NCCL, one rank per card: the path a multi-card user
takes (``launch.default_backend`` picks NCCL where each rank has its own
card, and the collectives then run on the card tensors without a host
copy).

Marked ``gpu``; each test skips with fewer than two CUDA devices. This file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_nccl.py
"""

import os
import sys

import pytest
import torch
import torch.distributed as dist

from dmesh_renderer_tpu_torch import parallel

pytestmark = pytest.mark.gpu

SPAWN_TIMEOUT = 300.0  # seconds for each spawn below
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")


@pytest.fixture
def ranks():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two CUDA devices or more")
    return min(n, 4)


def nccl_rank():
    """One rank: the mesh's backend and card, an all-reduce, a broadcast of
    the parameters from rank 0, and a barrier."""
    mesh = parallel.make_view_mesh()
    x = torch.full((3,), float(mesh.rank + 1), device=mesh.device)
    parallel.all_reduce(mesh, x)
    w = torch.full((2,), float(mesh.rank + 7), device=mesh.device,
                   requires_grad=True)
    (rep,) = parallel.replicate_params(mesh, (w,))
    parallel.barrier(mesh)
    return {"backend": dist.get_backend(mesh.group),
            "device": str(mesh.device), "rep_device": str(rep.device),
            "current": torch.cuda.current_device(), "sum": x.cpu(),
            "rep": rep.detach().cpu(), "requires_grad": rep.requires_grad}


def test_nccl_mesh_one_rank_per_card(ranks):
    assert parallel.default_backend(ranks, "cuda") == "nccl"
    out = parallel.spawn(nccl_rank, ranks, backend="nccl",
                         timeout=SPAWN_TIMEOUT)
    want_sum = float(ranks * (ranks + 1) // 2)
    for r, o in enumerate(out):
        assert o["backend"] == "nccl"
        assert o["device"] == o["rep_device"] == f"cuda:{r}"
        assert o["current"] == r
        assert torch.equal(o["sum"], torch.full((3,), want_sum))
        assert torch.equal(o["rep"], torch.full((2,), 7.0))
        assert o["requires_grad"]


@pytest.mark.parametrize("name, steps", [("port_optimize_tet", 60),
                                         ("port_optimize_triangles", 20)])
def test_examples_over_nccl(ranks, name, steps, tmp_path):
    """Each example with one rank per card: the loss falls, and the step
    resumed from the midpoint checkpoint repeats the uninterrupted one."""
    sys.path.insert(0, EXAMPLES)  # the ranks import the example by name
    try:
        r = __import__(name).main([
            "--device", "cuda", "--ranks", str(ranks), "--steps", str(steps),
            "--out-dir", str(tmp_path)])
    finally:
        sys.path.remove(EXAMPLES)
    losses = r["losses"]
    assert len(losses) == steps and losses[-1] < losses[0]
    assert r["resumed_loss"] == losses[steps // 2 + 1]
