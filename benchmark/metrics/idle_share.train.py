"""Share of the profiled train steps' window in which no kernel, memcpy or
memset ran on the card, in percent."""


def read(layer):
    t = layer.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t["busy_s"] / t["window_s"])
