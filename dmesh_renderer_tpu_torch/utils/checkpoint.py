"""Checkpoint / resume for optimisation loops (``torch.save``).

The counterpart of the JAX package's ``utils/checkpoint.py``. The renderer
is stateless; what needs checkpointing is the DMesh loop built on it
(``models/dmesh.py``): the scene's tensors, the per-view parameters where
there are any, and the ``torch.optim`` optimiser's ``state_dict()``.

A state is a tree of (Named)tuples and lists holding tensors, None and at
most one optimiser per tree position. Its "leaves" are its tensors and its
optimisers' parameter slots. A torch optimiser builds its moments at its
first ``step()``, so a fresh ``init_train_state`` has none while a
checkpoint taken after k steps has them; counting slots, not moments, lets
such a checkpoint restore into a fresh state, which is how a run resumes.
Each saved moment is checked against its parameter's shape and dtype.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def _parts(tree, tensors=None, optimizers=None):
    """The tensors and the optimisers of ``tree``, in tree order."""
    tensors = [] if tensors is None else tensors
    optimizers = [] if optimizers is None else optimizers
    if isinstance(tree, torch.Tensor):
        tensors.append(tree)
    elif isinstance(tree, torch.optim.Optimizer):
        optimizers.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _parts(x, tensors, optimizers)
    elif tree is not None:
        raise TypeError(f"checkpoint: cannot store a {type(tree).__name__}")
    return tensors, optimizers


def _slots(opt_states):
    """Each optimiser state dict's parameter slots, in order: (optimiser
    index, parameter id)."""
    return [(k, pid) for k, sd in enumerate(opt_states)
            for group in sd["param_groups"] for pid in group["params"]]


def save_checkpoint(path: str, state: Any, *, force: bool = True,
                    mesh=None) -> str:
    """Save ``state`` (e.g. ``models.dmesh.TrainState``) to the file
    ``path``; returns its absolute path. ``force=False`` refuses to
    overwrite. With ``mesh`` (every rank holds the same state), rank 0
    writes and every rank waits until it has."""
    from ..parallel.sharding import barrier

    path = os.path.abspath(path)
    if mesh is None or mesh.rank == 0:
        if os.path.exists(path) and not force:
            raise FileExistsError(
                f"checkpoint at {path} exists; pass force=True to "
                "overwrite it")
        tensors, optimizers = _parts(state)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save({"tensors": [t.detach() for t in tensors],
                    "optimizers": [o.state_dict() for o in optimizers]},
                   tmp)
        os.replace(tmp, path)
    if mesh is not None:
        barrier(mesh)
    return path


def restore_checkpoint(path: str, template: Any) -> Any:
    """Restore a checkpoint saved by ``save_checkpoint`` into ``template``
    (e.g. a freshly initialised ``TrainState``), which is returned: its
    tensors take the saved values in place (keeping their device and
    ``requires_grad``; its optimisers keep pointing at them) and its
    optimisers load the saved state.

    The saved leaves are validated against the template first: their count,
    and each one's shape and dtype. A checkpoint saved from another
    model/optimiser configuration fails with a message naming the mismatch
    instead of loading into garbage."""
    path = os.path.abspath(path)
    # on the CPU: load_state_dict moves each moment to its parameter's
    # device, and Adam's ``step`` stays on the CPU as in a fresh optimiser
    saved = torch.load(path, map_location="cpu", weights_only=True)
    tensors, optimizers = _parts(template)
    want_states = [o.state_dict() for o in optimizers]
    got_slots, want_slots = (_slots(saved["optimizers"]),
                             _slots(want_states))
    n_got = len(saved["tensors"]) + len(got_slots)
    n_want = len(tensors) + len(want_slots)
    if (n_got != n_want
            or len(saved["optimizers"]) != len(optimizers)):
        raise ValueError(
            f"checkpoint at {path} has {n_got} leaves but the template "
            f"has {n_want} -- it was saved from a different state "
            "structure (model/optimizer config mismatch)")
    pairs = list(enumerate(zip(saved["tensors"], tensors)))
    # each saved moment against its parameter (Adam's scalar ``step`` has
    # no shape to check)
    params = [p for o in optimizers for g in o.param_groups
              for p in g["params"]]
    for i, ((k, pid), param) in enumerate(zip(got_slots, params)):
        for value in saved["optimizers"][k]["state"].get(pid, {}).values():
            if isinstance(value, torch.Tensor) and value.dim() > 0:
                pairs.append((len(tensors) + i, (value, param)))
    for i, (got, want) in pairs:
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(
                f"checkpoint leaf {i} has shape {tuple(got.shape)} but the "
                f"template expects {tuple(want.shape)} (checkpoint at "
                f"{path} was saved from a different state configuration)")
        if got.dtype != want.dtype:
            raise ValueError(
                f"checkpoint leaf {i} has dtype {got.dtype} but the "
                f"template expects {want.dtype} (checkpoint at {path} was "
                "saved from a different state configuration)")
    with torch.no_grad():
        for got, want in zip(saved["tensors"], tensors):
            want.copy_(got)
    for opt, sd in zip(optimizers, saved["optimizers"]):
        opt.load_state_dict(sd)
    return template
