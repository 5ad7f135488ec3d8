"""Wall milliseconds a profiled train step, on the profiler's clock, of
the model's teacher-forced forward (``gst.train.forward``: Python
dispatch of its eager operations)."""

from benchmark.spans import of_run


def read(layer):
    s = of_run(layer)
    r = (s or {}).get("spans", {}).get("gst.train.forward")
    if not r:
        return None
    return 1e3 * r["wall_s"] / s["calls"]
