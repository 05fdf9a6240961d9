"""K2 (``csrc/tri_bwd.cu`` ``tri_bwd_kernel``), the tri backward composite,
as a share of its roofline over the traced steps (``_roofline.k2``)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_roofline", Path(__file__).with_name("_roofline.py"))
_r = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_r)

NEEDS_COUNTS = True


def read(run):
    return _r.share(run, "tri_bwd_kernel", _r.k2)
