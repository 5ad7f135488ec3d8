"""K5's share of its roofline: the least time of a call's sampling with
the input product hoisted (``work.wavernn_sample_work(hoisted=True)``) over
K5's device time a profiled call, in percent."""


def read(layer):
    t, bound = layer.get("trace"), layer.get("bounds", {}).get("wavernn_sample")
    spent = (t or {}).get("class_s", {}).get("wavernn_sample", 0.0)
    if not spent or bound is None:
        return None
    return 100.0 * bound * layer["traced_calls"] / spent
