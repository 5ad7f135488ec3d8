"""Model FLOPs of the synthesis calls completed in the untraced part of the
window, over its wall time, the cards used and the card's dense bf16 peak
(989 TFLOP/s, the highest of any precision the port computes in), in
percent. The FLOPs are ``benchmark/work.py``'s at the cell's shapes."""

from benchmark.work import MFU_PEAK_FLOPS


def read(layer):
    u = layer.get("untraced")
    if not u or u["wall_s"] <= 0 or u["calls"] <= 0:
        return None
    return 100.0 * u["flops"] / (u["wall_s"] * layer["chips"] * MFU_PEAK_FLOPS)
