"""``BENCHMARK.json`` and the files it names: each cell's configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), the
driver that its mix names (``drivers/<name>.py``) and its limits
(``limits/<cell>.json``), and each per-layer metric's reader
(``metrics/<name>.py``), found by name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]   # portbench/
ROOT = HERE.parent                            # the checkout


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell_name}.json").read_text())


def end_to_end(bench: dict, cell_name: str) -> list:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    moves = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def _module(folder: str, name: str):
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``."""
    return _module("metrics", name)


def driver_module(name: str):
    """Driver ``name`` of the traffic mixes: ``drivers/<name>.py``, whose
    ``run(run)`` fills a ``harness.runctx.Run``."""
    return _module("drivers", name)
