"""Wall milliseconds a profiled train step, on the profiler's clock, of
the optimizer's update (``gst.train.optimizer``: clipping, Adam, the
schedule)."""

from benchmark.spans import of_run


def read(layer):
    s = of_run(layer)
    r = (s or {}).get("spans", {}).get("gst.train.optimizer")
    if not r:
        return None
    return 1e3 * r["wall_s"] / s["calls"]
