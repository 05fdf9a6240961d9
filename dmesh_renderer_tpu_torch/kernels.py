"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"`` launchers
that return ``cudaGetLastError()``). It is compiled with nvcc for sm_90a
into ``_build/lib<name>.so`` at first use, or again when the source or a
header of ``csrc/`` (``*.cuh``) is newer than the library, and loaded with
ctypes. A build that fails raises: there is no fallback.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o _build/lib<name>.so csrc/<name>.cu

``--fmad=false`` keeps nvcc from contracting a*b+c into FMAs, so that the
kernels round as their plain torch versions do.

``csrc/spans.cu`` holds ``span_mark``, the one-thread kernel of the train
steps' stage marks (``utils/spans.py``): it appends (span id, step index,
``%globaltimer`` ns, counter) to a ring on the device, and is launched only
while spans are on (``utils.diagnostics.enable_spans``). With spans on,
``load`` and ``build`` also keep a host span, ``kernels.build``: the build
check, any compile and the library's load.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .utils import spans

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# argtypes of each library's launchers: pointers and the stream as c_void_p,
# sizes as c_int (c_int64 where they have no ceiling), f32 scalars as c_float
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
SIGNATURES = {
    "tri_fwd": {"tri_fwd_composite": [_P] * 8 + [_I] * 3 + [_P]},
    "tri_bwd": {"tri_bwd_composite": [_P] * 13 + [_I] * 3 + [_P],
                "seg_sum": [_P] * 4 + [_I] * 3 + [_P]},
    "tet_fwd": {"tet_first_hit": [_P] * 8 + [_I] * 3 + [_P],
                "tet_fwd_march": [_P] * 12 + [_I] * 5 + [_F, _P]},
    "tet_bwd": {"tet_bwd_march": [_P] * 13 + [_I] * 3 + [_P]},
    "tet_tables": {"tet_tables": [_P] * 14 + [_I] * 3 + [_P],
                   "tet_ray_start": [_P] * 15 + [_I] * 2 + [_P]},
    "binning": {"bin_count": [_P] * 16 + [_I] * 4 + [_P],
                "bin_runs": [_P] * 7 + [_I, _L] + [_I] * 3 + [_P],
                "bin_emit": [_P] * 7 + [_L] + [_I] * 5 + [_P]},
    "probes": {"take_rows": [_P] * 3 + [_I] * 2 + [_P],
               "roll_merge": [_P] * 2 + [_I] + [_P]},
    "march_probe": {"mega_step": [_P] * 5 + [_I] * 2 + [_P],
                    "two_table_step": [_P] * 7 + [_I] * 3 + [_P],
                    "proto_step": [_P] * 7 + [_I] * 3 + [_P]},
    "spans": {"span_mark": [_P] * 3 + [_I] * 4 + [_P]},
}

_loaded: dict[str, ctypes.CDLL] = {}
# each launcher's ctypes function, resolved once: (library, launcher) -> fn
_fns: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _paths(name: str):
    return SRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any header of
    ``csrc/`` (a source may include one)."""
    src, lib = _paths(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *SRC_DIR.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build(names=None, extra_flags=()) -> dict[str, str]:
    """Compile the named kernels (default: all) that are missing or older
    than their source, one nvcc process per source, all started together.
    Returns each compiler's output. Raises if any build fails."""
    with spans.host_block("kernels.build"):
        return _build(names, extra_flags)


def _build(names, extra_flags) -> dict[str, str]:
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        src, lib = _paths(name)
        fd, tmp = tempfile.mkstemp(prefix=f".lib{name}.", suffix=".so",
                                   dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", tmp, str(src)]
        procs[name] = (tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, lib, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with spans.host_block("kernels.build"):
            _build([name], ())
            lib = ctypes.CDLL(str(_paths(name)[1]))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def launcher(name: str, fn: str):
    """The ctypes function of the launcher ``fn`` of ``csrc/<name>.cu``,
    resolved once (the library built and loaded first if needed)."""
    f = _fns.get((name, fn))
    if f is None:
        f = _fns[(name, fn)] = getattr(load(name), fn)
    return f


def _current_device() -> int:
    return torch._C._cuda_getDevice()


def _raw_stream(index: int) -> int:
    """The handle of device ``index``'s current stream, without building a
    ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(index)


def check_tensors(name, want, device, contiguous=False):
    """Raise unless every (tensor, dtype, shape) of ``want`` has that dtype
    and shape, lies on ``device`` and, with ``contiguous``, is contiguous:
    the kernel wrappers' argument checks."""
    for t, dtype, shape in want:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name}: all tensors must share a device")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def launch(name: str, fn: str, tensors, scalars, device) -> None:
    """Call the launcher ``fn`` of ``csrc/<name>.cu`` with the tensors'
    pointers, then the scalars (as its ``SIGNATURES`` entry types them),
    then ``device``'s current stream. Raises if the launch failed. The
    caller keeps the tensors alive and contiguous.

    The per-call host work is kept small: the launcher is resolved once,
    pointers and the stream handle go to ctypes as plain ints, and the
    current device is switched only when it is not ``device`` already."""
    f = launcher(name, fn)
    index = device.index
    if index is None:  # "cuda": the current device
        index = _current_device()
    elif index != _current_device():
        with torch.cuda.device(index):
            return launch(name, fn, tensors, scalars, device)
    err = f(*[t.data_ptr() for t in tensors], *scalars, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")
