"""No process that a run starts outlives it, on the CPU: a run of each cell
at a small size (``cpu_cell.py``), killed mid-window by SIGTERM and by
SIGKILL, leaves no process behind; a run that ends normally leaves no
child and no new file in ``/dev/shm``; ``harness.procs`` finds a live
child and kills it. A process counts as the run's where its environment
holds the marker that the test gave the run, so that grandchildren and
processes re-parented after the run ended count too.

    python -m pytest portbench/tests/test_portbench_lifetime.py -q
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import uuid
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tests"))

import cpu_cell  # noqa: E402
from harness import procs  # noqa: E402

MARK = "PORTBENCH_LIFETIME_TEST"


def _marked(tag: str) -> list[int]:
    """Live processes whose environment holds ``MARK=tag``."""
    needle = f"{MARK}={tag}".encode()
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/environ", "rb") as f:
                env = f.read().split(b"\0")
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if needle in env and stat[stat.rindex(")") + 2] != "Z":
            out.append(int(entry))
    return out


def _start(cell: str, seconds: float, tag: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(HERE / "tests" / "cpu_cell.py"), cell, "11",
         str(seconds)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env={**os.environ, MARK: tag})


def _until_window(p: subprocess.Popen, timeout: float = 300.0) -> None:
    """Read the run's standard error until set-up has ended."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = p.stderr.readline()
        if not line:
            break
        if line.startswith("portbench: set-up"):
            return
    p.kill()
    pytest.fail("the run did not reach its window")


@pytest.mark.parametrize("cell", cpu_cell.cells())
@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGKILL],
                         ids=["SIGTERM", "SIGKILL"])
def test_killed_run_leaves_no_process(cell, sig):
    tag = uuid.uuid4().hex
    p = _start(cell, 600.0, tag)
    try:
        _until_window(p)
        time.sleep(1.0)
        assert p.poll() is None and _marked(tag)
        os.kill(p.pid, sig)
        p.wait(timeout=30)
        deadline = time.monotonic() + 10.0
        while _marked(tag) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert not _marked(tag)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        p.stdout.close()
        p.stderr.close()


@pytest.mark.parametrize("cell", cpu_cell.cells())
def test_normal_run_leaves_no_child_and_no_shm_file(cell):
    shm = os.path.isdir("/dev/shm")
    before = set(os.listdir("/dev/shm")) if shm else set()
    tag = uuid.uuid4().hex
    p = _start(cell, 1.0, tag)
    out, _err = p.communicate(timeout=600)
    assert p.returncode == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0
    assert not _marked(tag)
    after = set(os.listdir("/dev/shm")) if shm else set()
    assert after <= before


def test_a_live_child_is_found_and_killed():
    child = subprocess.Popen(["sleep", "60"])
    try:
        assert child.pid in procs.children()
        assert child.pid in procs.kill_children()
        assert child.pid not in procs.children()
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
