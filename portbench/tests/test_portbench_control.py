"""Each cell's comparison, shown to fail, on the CPU at a small size.

- The control (``harness/control.py``: the plain reference with its shading
  and blend in bfloat16, the configurations being float32) fails one of
  the cell's numbers against the cell's limits.
- A run of the cell (``cpu_cell.py``: the harness's whole run without its
  look for a card) with the timed path broken underneath, once for each
  fault the cell can have (``harness/faults.py``), comes out not correct;
  the same run unbroken comes out correct.

    python -m pytest portbench/tests/test_portbench_control.py -q
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tests"))

import cpu_cell  # noqa: E402
from harness import control, scenes, spec  # noqa: E402

BENCH = spec.load_benchmark(ROOT)
CELLS = cpu_cell.cells()


def _setup(cell: str):
    ov = cpu_cell.overrides(cell)
    w = spec.cell(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    tr = spec.traffic(w["traffic"])
    cfg.update(ov["config"])
    tr.update(ov["traffic"])
    scene, gen = scenes.make_scene(cfg, 21, "cpu")
    return cfg, tr, scene, gen, spec.limits(cell)


def _driver(cell: str) -> str:
    return spec.traffic(spec.cell(BENCH, cell)["traffic"])["driver"]


def _fails(numbers: dict, limits: dict) -> bool:
    return any(not v <= limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if _driver(c) == "train"])
def test_control_fails_train_cell(cell):
    cfg, tr, scene, gen, limits = _setup(cell)
    per = int(tr["views_per_step"])
    n = int(tr["reference_steps"])
    pool = scenes.make_views(cfg, scene, gen, n * per, targets=True)
    steps = [pool.take(list(range(k * per, (k + 1) * per))) for k in range(n)]
    numbers = control.train_numbers(cfg, scene, steps)
    assert _fails(numbers, limits), numbers


# the faults each driver's cells can have (``harness/faults.py``)
FAULTS = {"train": ["state_unchanged"]}


def _faults(cell: str) -> list:
    return FAULTS[_driver(cell)]


def _run(cell: str, fault: str | None) -> dict:
    args = [sys.executable, str(HERE / "tests" / "cpu_cell.py"), cell, "31",
            "1"] + ([fault] if fault else [])
    p = subprocess.run(args, capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in _faults(c)])
def test_fault_is_not_correct(cell, fault):
    line = _run(cell, fault)
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_unbroken_run_is_correct(cell):
    line = _run(cell, None)
    assert line["correct"] is True, line["compared"]
    assert list(line)[-1] == "compared"


def test_bfloat16_is_the_control():
    assert control.CONTROL is torch.bfloat16
