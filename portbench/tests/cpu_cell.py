"""Run one cell of ``BENCHMARK.json`` on the CPU at a small size, for the
tests: the harness's whole run without its look for a card. Prints the
compared numbers on standard error and the result line.

    python portbench/tests/cpu_cell.py <cell> <seed> <seconds> [fault]

``fault`` names one of ``harness/faults.py``'s planted faults.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import run as portbench_run  # noqa: E402

SMALL = {
    "tri": {"config": {"faces": 300, "height": 64, "width": 64}},
    "tet": {"config": {"grid": 3, "height": 48, "width": 48}},
}
# the small sizes of each driver's traffic parameters
TRAFFIC = {
    "train": {"view_pool": 4, "reset_every": 2, "sync_every": 2,
              "warmup_s": 0, "trace_steps": 2},
}


def bench() -> dict:
    return json.loads((HERE.parent / "BENCHMARK.json").read_text())


def cells() -> list:
    return [w["name"] for w in bench()["workloads"]]


def overrides(cell: str, fault: str | None = None) -> dict:
    b = bench()
    w = next(x for x in b["workloads"] if x["name"] == cell)
    cfg = json.loads((HERE.parent / next(
        c["file"] for c in b["configs"] if c["name"] == w["config"])
    ).read_text())
    tr = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    out = dict(SMALL[cfg["renderer"]])
    out["traffic"] = dict(TRAFFIC[tr["driver"]])
    if fault:
        out["fault"] = fault
    return out


def main(argv) -> None:
    portbench_run._env()
    cell, seed, seconds = argv[0], int(argv[1]), float(argv[2])
    fault = argv[3] if len(argv) > 3 else None
    run = portbench_run.run_cell(cell, seed, seconds, False, device="cpu",
                                 overrides=overrides(cell, fault))
    run.print_compared()
    print(json.dumps(run.result_line), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
