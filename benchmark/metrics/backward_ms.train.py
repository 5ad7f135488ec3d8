"""Wall milliseconds a profiled train step, on the profiler's clock, of
autograd's backward (``gst.train.backward``)."""

from benchmark.spans import of_run


def read(layer):
    s = of_run(layer)
    r = (s or {}).get("spans", {}).get("gst.train.backward")
    if not r:
        return None
    return 1e3 * r["wall_s"] / s["calls"]
