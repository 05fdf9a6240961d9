"""What the two parity fuzz harnesses share: the repository's NumPy test
helpers loaded by path, the kernels' launch counters, and the sweep loop
with its command line.

The scene helpers (``tests/scenes.py``) and the float64 scalar spec
(``tests/numpy_reference.py``) import only NumPy. The harnesses load them
from the repository checkout beside this package, so that a config of a
seed is the same scene the JAX package's harnesses draw.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
TESTS_DIR = REPO_ROOT / "tests"


def load_test_module(name: str):
    """``tests/<name>.py`` of the repository, imported by path under the
    module name ``dmesh_fuzz_<name>`` (once per process)."""
    key = f"dmesh_fuzz_{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = TESTS_DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"the fuzz harnesses need the repository's tests/{name}.py (NumPy "
            f"scene helpers and scalar spec); it is not at {path}: run them "
            f"from a checkout of the repository")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules[key] = mod
    return mod


def launch_counts():
    """The launch counts of K1-K5 and ``seg_sum`` so far (each wrapper's
    ``.launches`` grows by one per kernel launch)."""
    from ..ops import reduce, tet, tet_first_hit, tri_binned

    return {"K1": tri_binned.fwd_composite.launches,
            "K2": tri_binned.bwd_composite.launches,
            "seg_sum": reduce.seg_sum.launches,
            "K3": tet_first_hit.first_hit.launches,
            "K4": tet.fwd_march.launches, "K5": tet.bwd_march.launches}


def parse_args(argv, prog, default_n, default_start):
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("n_configs", nargs="?", type=int, default=default_n)
    ap.add_argument("start_seed", nargs="?", type=int, default=default_start)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--big", action="store_true",
                    help="the card-only sizes (needs --device cuda)")
    args = ap.parse_args(argv)
    if args.big and args.device != "cuda":
        ap.error("--big compares the card at sizes the CPU's plain kernels "
                 "cannot sweep; it needs --device cuda")
    return args


def report(results, launched, device, kernels):
    """Print the total and every failure; ``results`` is a list of (label,
    errors). On the card, a sweep in which one of ``kernels`` never
    launched has failed. Returns the exit code."""
    n = len(results)
    failures = [(label, errs) for label, errs in results if errs]
    print(f"\n{n - len(failures)}/{n} configs clean; launches "
          + ", ".join(f"{k} {launched.get(k, 0)}" for k in kernels)
          + ("" if device.type == "cuda"
             else " (plain versions on the CPU: no launches)"), flush=True)
    idle = [k for k in kernels if not launched.get(k, 0)]
    if device.type == "cuda" and n and idle:
        failures.append(("sweep", [f"{', '.join(idle)} never launched"]))
    for label, errs in failures:
        print(f"FAIL {label}: {'; '.join(errs)}", flush=True)
    return 1 if failures else 0
