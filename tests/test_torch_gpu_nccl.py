"""The view mesh over NCCL, one rank per card: the path a multi-card user
takes (``launch.default_backend`` picks NCCL where each rank has its own
card, and the collectives then run on the card tensors without a host
copy). The sharded train steps and loops of both renderers are captured as
CUDA graphs there, the all-reduce inside: at the small scenes of
``test_torch_gpu_mesh_graph.py``, one view per rank, captured sharded steps
bitwise the eager ones on every rank, every rank bitwise the others after
every step, a record overflow forced on one rank taken by the exact
fallback on every rank (no hang), and the SGD step against one process's
step on all the views.

Marked ``gpu``; each test skips with fewer than two CUDA devices. This file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_nccl.py
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dmesh_renderer_tpu_torch import parallel
from test_torch_gpu_mesh_graph import check_rank, mesh_rank, problem

pytestmark = pytest.mark.gpu

SPAWN_TIMEOUT = 300.0  # seconds for each spawn below
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")
# one process's step on every view against the sharded step: JAX's
# test_sharding.py tolerances (as chip_smoke.py's MV_LOSS_RTOL; parameters
# rtol 2e-5, atol 1e-7) and the binned path's gradients at 1e-4 rel
LOSS_RTOL = {"tri": 1e-6, "tet": 2e-5}
GRAD_RTOL = 1e-4


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


@pytest.fixture(scope="module")
def mesh_runs():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two CUDA devices or more")
    n = min(n, 4)
    # the last rank forces the record overflow alone
    return parallel.spawn(mesh_rank, n, (n - 1,), backend="nccl",
                          timeout=SPAWN_TIMEOUT)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_captured_sharded_steps_over_nccl(mesh_runs, kind):
    """Every rank: captured sharded steps and the loop bitwise the eager
    sharded steps, the replayed step's host syncs, and the overflow forced
    on the last rank alone taken by the exact fallback on every rank
    (``test_torch_gpu_mesh_graph.check_rank``); every rank bitwise the
    others after every step; the eager SGD step against one process's
    step on all the views."""
    n = len(mesh_runs)
    assert [r["rank"] for r in mesh_runs] == list(range(n))
    for r in mesh_runs:
        assert (r["backend"], r["capturable"]) == ("nccl", True)
        assert r["device"] == f"cuda:{r['rank']}"
        check_rank(r, kind)
    first = mesh_runs[0][kind]
    for r in mesh_runs[1:]:
        for run in ("eager", "captured", "forced"):
            if run in first:
                assert r[kind][run]["losses"] == first[run]["losses"]
                assert r[kind][run]["digests"] == first[run]["digests"]
        assert r[kind]["loop"] == first["loop"]
        assert r[kind]["sgd"]["loss"] == first["sgd"]["loss"]
        for a, b in zip(r[kind]["sgd"]["scene"], first["sgd"]["scene"]):
            assert torch.equal(a, b)
    fresh, make_step, _loop, batch = problem(kind, torch.device("cuda", 0),
                                             n)
    st, loss = make_step(capture=False)(fresh(sgd=True), batch)
    sgd = first["sgd"]
    assert np.isclose(sgd["loss"], float(loss), rtol=LOSS_RTOL[kind])
    for a, b in zip(sgd["scene"], st.scene):
        np.testing.assert_allclose(a.numpy(), b.detach().cpu().numpy(),
                                   rtol=2e-5, atol=1e-7)
    for g, p in zip(sgd["grads"], st.scene):
        assert bool(p.grad.any()) and _rel(g, p.grad.cpu()) <= GRAD_RTOL


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
