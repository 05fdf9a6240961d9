"""The tri record reduce's device ms a step: the mean of the program
span ``tri.reduce`` over the traced steps (``ops/tri_binned.py``'s
``reduce_records``: ``segment_csr``, ``seg_sum`` and the sums to faces and
vertices; ``_spans.py``)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_spans", Path(__file__).with_name("_spans.py"))
_s = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_s)


def read(run):
    return _s.reading(run, "tri_reduce_ms")
