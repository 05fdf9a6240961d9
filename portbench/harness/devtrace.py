"""What a traced window's ``torch.profiler`` trace says: device busy time,
device time by kernel name, and the idle gaps with what the host was
doing. A frozen copy of the arithmetic of the program's
``utils/diagnostics.py`` (``device_busy_ms``, ``device_time_by_name``),
with the gaps added."""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def traced(dev):
    """Profile the block (CPU and CUDA activity) between two device
    synchronisations; yields a dict that holds the summary once the block
    ends (``summarize``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: dict = {}
    cuda = torch.device(dev).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield out
        sync()
        window_s = time.perf_counter() - t0
    out.update(summarize(prof, window_s))


def summarize(prof, window_s: float) -> dict:
    """busy_s (the union of the device events' intervals), window_s, by_name
    {kernel name: (count, seconds)}, device_ops (the ten largest by time)
    and idle_gaps (the ten longest gaps between device events, each named
    by the innermost host op running when it opened)."""
    import torch

    dev_ev, cpu_ev = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_ev.append((span[0], span[1], e.name))
        else:
            cpu_ev.append((span[0], span[1], e.name))
    dev_ev.sort()
    busy, end, gaps = 0.0, None, []
    for a, b, _n in dev_ev:
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name: dict = {}
    for a, b, n in dev_ev:
        c = by_name.setdefault(n, [0, 0.0])
        c[0] += 1
        c[1] += (b - a) / 1e6
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        host = [(a, n) for a, b, n in cpu_ev if a <= g0 < b]
        label = max(host)[1] if host else "host idle"
        named.append([label, (g1 - g0) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"busy_s": busy / 1e6, "window_s": window_s,
            "by_name": {k: tuple(v) for k, v in by_name.items()},
            "device_ops": [[k, v[1]] for k, v in ops[:10]],
            "idle_gaps": named}


def kernel_seconds(summary: dict, word: str) -> float | None:
    """Device seconds of the events whose name holds ``word``, or None."""
    hits = [s for name, (_c, s) in summary["by_name"].items() if word in name]
    return sum(hits) if hits else None


def host_syncs(fn) -> int:
    """The host syncs of ``fn()`` as PyTorch's sync debug mode reports them
    (a frozen copy of ``tools/tri_step_ms.host_syncs``)."""
    import warnings

    import torch

    if not torch.cuda.is_available():
        fn()
        return 0
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum(str(w.message).startswith("called a synchronizing")
               for w in seen)

