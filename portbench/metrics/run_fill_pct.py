"""The fill of the tri binning's run table, %: 100 x the program's counter
``tri.runs`` (the (face, tile-row) runs of a step, ``ops/binning.py``)
over ``tri.runs.capacity`` (the table's rows, which the program's span
report gives beside it), the mean over the traced steps (``_spans.py``'s
aggregate). Every row of the table, live or not, goes through the run
glue, so a fuller table wastes less; above 100 the table overflowed and
dropped runs. None where the program has no such counter."""

import importlib.util
import sys
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_spans", Path(__file__).with_name("_spans.py"))
_s = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_s)


def read(run):
    rep = _s.report(run)
    if rep is None:
        return None
    counters = rep["traced"]["counters"]
    runs = counters.get("tri.runs")
    caps = counters.get("tri.runs.capacity")
    if not runs or not caps or len(runs) != len(caps):
        return None
    pct = 100.0 * sum(r / c for r, c in zip(runs, caps)) / len(runs)
    print(f"portbench: tri.runs over {len(runs)} traced steps: mean "
          f"{sum(runs) / len(runs):.1f}, max {max(runs)}, of "
          f"{max(caps)} rows: {pct:.2f}%", file=sys.stderr, flush=True)
    return pct
