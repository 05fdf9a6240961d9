"""K5 (``csrc/tet_bwd.cu`` ``tet_bwd_march_kernel``), the tet backward march,
as a share of its roofline over the traced steps (``_roofline.k5``)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_roofline", Path(__file__).with_name("_roofline.py"))
_r = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_r)

NEEDS_COUNTS = True


def read(run):
    return _r.share(run, "tet_bwd_march_kernel", _r.k5)
