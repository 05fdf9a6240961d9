"""Faults planted under the timed path, for the tests that show each cell's
comparison failing them (``tests/test_portbench_control.py``). A run plants
one only where its overrides name it; the benchmark's own runs never do.

- ``state_unchanged``: the optimiser's step does nothing, so a train step
  returns its state unchanged. (A one-card train cell at one view a step
  has no other of the contract's faults: no half of a batch, no exchange
  between cards, no served answer.)
"""

from __future__ import annotations


def plant(name: str | None) -> None:
    if name is None:
        return
    import torch

    if name == "state_unchanged":
        torch.optim.Adam.step = lambda self, closure=None: None
        return
    raise ValueError(f"unknown fault {name!r}")
