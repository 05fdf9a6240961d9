"""The benchmark's files against ``BENCHMARK.json`` and its contract, on the
CPU: every cell, configuration, traffic mix, the driver it names, limit
file and per-layer metric named there resolves to its file; names, units
and texts keep to the allowed characters and lengths; the plain reference
imports nothing of JAX, the JAX package or the port; a traced run works. Run from the root of a checkout:

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

from harness import spec  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "dmesh_renderer_tpu",
             "dmesh_renderer_tpu_torch"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert PATH.match(p) and (ROOT / p).is_dir()


def test_configs_resolve():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and _line(w["why"])
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    tr = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    assert NAME.match(tr["driver"])
    assert callable(spec.driver_module(tr["driver"]).run)
    if tr["driver"] == "train":
        assert w["chips"] == 1
        assert tr["sync_every"] % tr["reset_every"] == 0
        assert tr["view_pool"] >= tr["reference_steps"]
    limits = json.loads((HERE / "limits" / f"{w['name']}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())
    # every cell reports set-up, another end-to-end metric and a per-layer
    # metric
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(w["name"] in m.get("workloads", []) for m in BENCH["per_layer"])


def test_pairs_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert callable(spec.metric_module(m["name"]).read)
        layers.setdefault(m["layer"], []).append(m["name"])
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells)
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_files_named_from_names():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or not p.is_file():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


REFERENCE = sorted((HERE / "reference").glob("*.py")) + [
    HERE / "harness" / f for f in ("refside.py", "compare.py", "scenes.py",
                                   "tetgrid.py")]


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_jax_or_the_port(path):
    assert not _imports(path) & FORBIDDEN


def test_reference_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.tri, reference.tet, harness.refside, "
            "harness.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    assert not set(eval(out)) & FORBIDDEN


def test_run_refuses_without_the_cards():
    """Without a card (or with fewer than the cell asks for) the run exits
    non-zero and prints no result."""
    import torch

    cell = max(BENCH["workloads"], key=lambda w: w["chips"])
    if torch.cuda.is_available() and torch.cuda.device_count() >= cell[
            "chips"]:
        pytest.skip("the cards are here")
    cell = cell["name"]
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        cell, "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_a_run_on_the_card_loads_no_jax(card):
    """A short run of the first one-card cell: a result line, and none of
    JAX's, flax's or the JAX package's modules loaded (``run.py`` refuses
    to print otherwise)."""
    cell = next(w["name"] for w in BENCH["workloads"] if w["chips"] == 1)
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        cell, "--seed", "3", "--seconds", "2"],
                       capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_traced_run_counts_each_step_at_its_parameters(cell):
    """A traced run on the CPU at a small size: its per-layer line, and the
    rooflines' inputs, one (views, parameters) pair per traced step, each
    step at the parameters it started from."""
    import torch

    sys.path.insert(0, str(HERE / "tests"))
    import cpu_cell
    import run as portbench_run

    portbench_run._env()
    ov = cpu_cell.overrides(cell)
    reset = ov["traffic"]["reset_every"]
    # the CPU's trace holds every eager op: few steps, one past a reset
    ov["traffic"]["trace_steps"] = n = reset + 1
    run = portbench_run.run_cell(cell, 5, 1.0, True, device="cpu",
                                 overrides=ov)
    line = run.result_line
    assert line["correct"] is True and line["attempted"] == n
    assert {"device_idle_pct.train", "host_syncs_per_step"} <= set(
        line["metrics"])
    assert line["device"]["busy_s"] >= 0 and line["device"]["window_s"] > 0
    pairs = run.trace_inputs
    assert len(pairs) == n
    params = [p for _v, p in pairs]
    # a step starts from the parameters the step before it left; a reset
    # starts again from the first
    assert not all(torch.equal(a, b) for a, b in zip(params[0], params[1]))
    assert all(torch.equal(a, b) for a, b in zip(params[0], params[reset]))
    assert run.counts and all(v > 0 for v in run.counts.values())


def test_traced_steps_share_the_pair_of_their_period():
    """Step k of a traced window starts from step (k mod lcm(reset_every,
    views))'s views and parameters, taken by running one period."""
    import torch

    drv = spec.driver_module("train")

    class Prog:
        def __init__(self):
            self.since, self.calls = 0, 0

        def reset(self):
            self.since = 0

        def params(self):
            return [torch.tensor(float(self.since))]

        def __call__(self, batch):
            self.since += 1
            self.calls += 1

    prog, views = Prog(), ["v0", "v1", "v2", "v3"]
    pairs = drv._inputs_of_steps(prog, views, views, 10, 2)
    assert prog.calls == 4 and len(pairs) == 10
    for k, (v, p) in enumerate(pairs):
        assert v == views[k % 4] and float(p[0]) == k % 2
        assert pairs[k] is pairs[k % 4]
