"""K4's share of its roofline: the least time of a call's decode at its
shapes (B, padded T, steps; ``work.decode_scan_work``) over the device
time of K4's phase kernels a profiled call, in percent."""


def read(layer):
    t, bound = layer.get("trace"), layer.get("bounds", {}).get("decode_scan")
    spent = (t or {}).get("class_s", {}).get("decode_scan", 0.0)
    if not spent or bound is None:
        return None
    return 100.0 * bound * layer["traced_calls"] / spent
