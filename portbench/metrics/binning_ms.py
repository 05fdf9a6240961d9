"""The binning's device ms a step: the mean of the program span
``tri.binning`` over the traced steps (``ops/binning.py``'s
``emit_and_sort``, its counts, sorts and run table; ``_spans.py``)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_spans", Path(__file__).with_name("_spans.py"))
_s = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_s)


def read(run):
    return _s.reading(run, "binning_ms")
