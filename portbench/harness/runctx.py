"""One run of one cell: its inputs, what it measured, and its result line.

A driver (``drivers/<name>.py``, named by the cell's traffic file) fills
a ``Run``; the per-layer metrics' readers (``metrics/<name>.py``) read it
at the end: ``read(run)`` returns a number, or None where there is nothing
to read (the metric is then left out of the line).
"""

from __future__ import annotations

import json
import sys
import time

import torch

from . import compare, spec


class Run:
    def __init__(self, bench: dict, cell_name: str, seed: int,
                 seconds: float, trace: bool, dev, t0: float,
                 overrides: dict | None = None):
        # the tests' overrides: small sizes ({"config": {...}, "traffic":
        # {...}}) and a planted fault
        ov = overrides or {}
        self.cell = spec.cell(bench, cell_name)
        self.cfg = spec.config(bench, self.cell["config"])
        self.traffic = spec.traffic(self.cell["traffic"])
        self.limits = spec.limits(cell_name)
        self.fault = ov.get("fault")
        self.cfg.update(ov.get("config", {}))
        self.traffic.update(ov.get("traffic", {}))
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.dev = torch.device(dev)
        self.t0 = t0
        self.metrics, self.compared = {}, {}
        self.correct, self.attempted, self.failed = False, 0, 0
        self.memory_peak = 0
        self.scene = None
        self.trace_summary, self.trace_units = None, 0
        # (views, parameters before the step) of each traced step
        self.trace_inputs = None
        self.syncs_per_step = self.counts = None
        self.marks = [("start", t0)]  # set-up's parts, by the host clock
        self.readers = ([(m, spec.metric_module(m["name"]))
                         for m in spec.per_layer(bench, cell_name)]
                        if trace else [])

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def mark(self, part: str) -> None:
        """Set-up's part ``part`` ends here."""
        self.marks.append((part, time.perf_counter()))

    def setup_done(self) -> None:
        """Set-up ends here: the window starts."""
        setup = time.perf_counter() - self.t0
        if not self.trace:
            self.metric("setup_s", setup, "s")
        parts = " ".join(f"{b[0]}={b[1] - a[1]:.3f}"
                         for a, b in zip(self.marks, self.marks[1:]))
        say(f"portbench: set-up {setup:.3f} s: {parts}")

    def metric(self, name: str, value: float, unit: str) -> None:
        self.metrics[name] = {"value": float(value), "unit": unit}

    def read_memory(self) -> None:
        if self.dev.type == "cuda":
            self.memory_peak = max(self.memory_peak,
                                   torch.cuda.max_memory_allocated(self.dev))

    def read_metrics(self) -> None:
        if any(getattr(mod, "NEEDS_COUNTS", False) for _m, mod in
               self.readers) and self.trace_inputs:
            self.counts = self._counts()
        for m, mod in self.readers:
            value = mod.read(self)
            if value is not None:
                self.metric(m["name"], value, m["unit"])

    def _counts(self) -> dict:
        """The work the traced steps need, each at its own views and
        parameters, counted by the plain reference's forward on them
        (``metrics/_roofline.py`` reads it)."""
        from . import refside

        total, seen = {}, {}
        with torch.no_grad():
            for pair in self.trace_inputs:
                key = id(pair)
                if key not in seen:
                    seen[key] = {}
                    refside.render(self.cfg, self.scene, pair[0], pair[1],
                                   counts=seen[key])
                for k, v in seen[key].items():
                    total[k] = total.get(k, 0) + v
        return total

    def compare(self, numbers: dict) -> None:
        ok, self.compared = compare.judge(numbers, self.limits)
        self.correct = ok and self.failed == 0

    def result(self, device: dict, breakdown: dict | None) -> dict:
        out = {"correct": bool(self.correct), "attempted": int(self.attempted),
               "failed": int(self.failed), "metrics": self.metrics,
               "device": device}
        if breakdown is not None:
            out["breakdown"] = breakdown
        out["compared"] = self.compared
        return out

    def print_compared(self) -> None:
        for k, v in self.compared.items():
            say(f"compared {k} {v['value']!r} limit {v['limit']!r}")


def say(line: str) -> None:
    """One line on standard error in one write."""
    sys.stderr.write(line + "\n")
    sys.stderr.flush()


def emit(result: dict) -> None:
    print(json.dumps(result), flush=True)
