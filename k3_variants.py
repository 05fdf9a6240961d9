"""Time the tet first-hit kernel K3 against variants of its own source on
one CUDA card, at the tet headline (98,400 faces, 800x800) at B=1 and B=2.

    python3 k3_variants.py

Each variant is a copy of dmesh_renderer_tpu_torch/csrc/tet_fwd.cu with one
line changed (the steps' unroll, the round size, the packing of live
pixels turned off), built with the package's nvcc flags into the gitignored
``.smoke_tree/k3_variants/`` and called through ctypes on the inputs that
``chip_smoke.tet_stages`` builds. Every variant is checked bit for bit
against the plain version (first face, t/u/v) and prints its staged rows;
the times are CUDA events over 20 calls after 3 warm-ups, taken in the
order A B ... B A, and the device time under the profiler. Needs nvcc and
a card; exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT = ROOT / ".smoke_tree" / "k3_variants"
# name -> (line of tet_fwd.cu, its replacement); "committed" changes none
VARIANTS = {
    "committed": None,
    "one_slot_a_step": ("constexpr int kUnroll = 4;",
                        "constexpr int kUnroll = 1;"),
    "two_slots_a_step": ("constexpr int kUnroll = 4;",
                         "constexpr int kUnroll = 2;"),
    "no_packing": ("if (__syncthreads_count(busy && lane == 0) > "
                   "(n_live + 31) / 32) {",
                   "if (__syncthreads_count(busy && lane == 0) < 0) {"),
    "64_slot_rounds": ("constexpr int kRound = 32;",
                       "constexpr int kRound = 64;"),
}


def build():
    from dmesh_renderer_tpu_torch import kernels

    src = (kernels.SRC_DIR / "tet_fwd.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, change in VARIANTS.items():
        text = src
        if change is not None:
            if change[0] not in text:
                raise SystemExit(f"{name}: the line to change is gone")
            text = text.replace(change[0], change[1])
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(kernels.SRC_DIR), "-o", str(OUT / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        lib.tet_first_hit.argtypes = kernels.SIGNATURES["tet_fwd"][
            "tet_first_hit"]
        libs[name] = lib
        print(f"{name}: {cs.ptxas_usage({name: log}, 'tet_first_hit')}")
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device available", file=sys.stderr)
        return 1
    from dmesh_renderer_tpu_torch.ops import tet_first_hit as pfh

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = build()
    for views in (1, 2):
        H = W = 800
        _u, fargs, _bg = cs.tet_user(20, views, 0.15, 2, dev)
        seq, _st, fh_in, _m = cs.tet_stages(fargs, H, W)
        for _n, fn in seq[:4]:  # projection, binning, table, rays
            fn()
        fh = fh_in()
        ins = [x.contiguous() for x in fh[:5]]
        want = pfh.first_hit_plain(*fh)

        def call(name):
            out = (torch.empty((views, 3, H, W), device=dev),
                   torch.empty((views, H, W), dtype=torch.int32, device=dev),
                   torch.empty((views, 25, 25), dtype=torch.int32,
                               device=dev))
            err = libs[name].tet_first_hit(
                *[x.data_ptr() for x in (*ins, *out)], views, H, W,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{name}: launch failed ({err})")
            return out

        for name in VARIANTS:
            tuv, face, walked = call(name)
            torch.cuda.synchronize()
            ok = torch.equal(face, want[0]) and all(
                torch.equal(tuv[:, i], want[1 + i]) for i in range(3))
            if not ok:
                raise SystemExit(f"{name}: differs from first_hit_plain")
            print(f"B={views} {name}: bit-equal, rows staged "
                  f"{int(walked.long().sum())}")
        order = list(VARIANTS) + list(VARIANTS)[::-1]
        ms = {name: [] for name in VARIANTS}
        for name in order:
            ms[name].append(cs.cuda_ms(lambda: call(name), 3, 20))
        for name in VARIANTS:
            d = cs.profiled_device_ms(lambda: call(name),
                                      "tet_first_hit_kernel")
            print(f"B={views} {name}: ms {ms[name][0]:.4f} "
                  f"{ms[name][1]:.4f}, device {d:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
