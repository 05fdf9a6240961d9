"""The benchmark of the PyTorch and CUDA port (``dmesh_renderer_tpu_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``, a file of parameters that names its driver,
``drivers/<driver>.py``, which builds the inputs from the seed, drives the
window and compares), the comparison with the plain reference
(``reference/``) against the cell's limits (``limits/<cell>.json``), and
with ``--trace 1`` its per-layer metrics (``metrics/<name>.py``). Each is
found by its name, so a cell, a mix, a driver, a configuration or a metric
is added by adding files and entries. The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``: each
compared number beside its limit, which also end standard error).

It exits non-zero and prints no result where the cards the cell asks for
are missing, where a module of JAX or the JAX package is loaded once the
window has closed, or where a child process is still alive before the
result is printed. Every build and kernel cache stays inside
the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dmesh_renderer_tpu")


def _env() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through a
    library."""
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the benchmark's own packages first: the checkout's root holds other
    # top-level modules
    for p in (str(ROOT), str(HERE)):
        while p in sys.path:
            sys.path.remove(p)
        sys.path.insert(0, p)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _args(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _card_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None):
    """One run of a cell on ``device`` (the card, or the CPU in the tests,
    with ``overrides`` of the configuration and the traffic): returns the
    Run, with ``result_line`` set."""
    import torch

    from harness import spec
    from harness.runctx import Run

    bench = spec.load_benchmark(ROOT)
    dev = torch.device(device)
    run = Run(bench, workload, seed, seconds, trace, dev, T0, overrides)
    cell = run.cell
    spec.driver_module(run.traffic["driver"]).run(run)
    run.read_metrics()
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(0)
    else:
        name = "cpu"
    device_out = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": name, "count": int(cell["chips"]),
                  "memory_peak_bytes": int(run.memory_peak)}
    breakdown = None
    if trace and run.trace_summary is not None:
        s = run.trace_summary
        device_out.update(busy_s=s["busy_s"], window_s=s["window_s"])
        breakdown = {"device_ops": s["device_ops"],
                     "idle_gaps": s["idle_gaps"]}
    run.result_line = run.result(device_out, breakdown)
    return run


def main(argv=None) -> int:
    _env()
    a = _args(argv)
    import torch

    from harness import procs, spec

    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, a.workload)
    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell {a.workload} needs {need} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr, flush=True)
        return 2
    run = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr, flush=True)
        return 3
    print(f"portbench: card {_card_limit()}", file=sys.stderr, flush=True)
    left = procs.kill_children()
    if left:
        print(f"portbench: child processes still alive, killed: {left}",
              file=sys.stderr, flush=True)
        return 4
    run.print_compared()
    from harness.runctx import emit

    emit(run.result_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
