"""The tet record reduce's device ms a step: the mean of the program
span ``tet.reduce`` over the traced steps (``ops/tet.py``'s
``reduce_tet_records``: ``segment_csr``'s sort, ``seg_sum`` and
``corner_sum``; ``_spans.py``)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_spans", Path(__file__).with_name("_spans.py"))
_s = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_s)


def read(run):
    return _s.reading(run, "tet_reduce_ms")
