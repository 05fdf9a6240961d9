"""The card's wait between train steps, device ms: from one step's
closing mark (``step.optimizer``) to the next step's opening mark
(``step.open``), the mean over the traced window's gaps: the host's loop,
the batch copies and the replay's launch (``models/dmesh.py``;
``_spans.py``). Read under ``torch.profiler``, whose host work lengthens
the wait wherever the card waits for the host (the tet step, after its
flag read); the stderr line gives the same wait without the profiler."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_spans", Path(__file__).with_name("_spans.py"))
_s = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_s)


def read(run):
    return _s.reading(run, "replay_gap_ms")
