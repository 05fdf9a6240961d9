"""The card's wait between the tet step's two graphs, device ms a step:
from G1's closing mark (``step.grads``) to G2's opening mark
(``step.resume``), the time the host takes to read the record overflow flag
and launch G2 (``models/dmesh.py``; ``_spans.py``). Read over the traced
window, under ``torch.profiler``, whose host work lengthens the wait; the
stderr line gives the same wait without the profiler."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_spans", Path(__file__).with_name("_spans.py"))
_s = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_s)


def read(run):
    return _s.reading(run, "flag_wait_ms")
