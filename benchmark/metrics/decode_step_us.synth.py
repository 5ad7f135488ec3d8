"""Device microseconds of K4's phase kernels a decoder step: K4's device
time over the profiled calls, over the steps they decoded (the program's
``decode_steps`` over its ``calls``, a call's steps, times the profiled
calls). It puts K4's branches side by side a step at a time, whatever a
cell's step budget: Bahdanau at r=2 and location-sensitive at r=1."""

from benchmark.spans import counters_of_run


def read(layer):
    t, c = layer.get("trace"), counters_of_run(layer)
    spent = (t or {}).get("class_s", {}).get("decode_scan", 0.0)
    if not spent or not c or not c.get("calls") or not c.get("decode_steps"):
        return None
    return 1e6 * spent / (layer["traced_calls"] * c["decode_steps"] / c["calls"])
