"""The card's idle share over a traced window of train steps: 100 x (1 -
the union of the device events' intervals / the window's wall time), under
``torch.profiler``."""


def read(run):
    s = run.trace_summary
    if s is None or not s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
