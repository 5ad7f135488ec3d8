"""Model FLOPs of the train steps completed in the untraced part of the
window (three times the teacher-forced forward's at the batch's shapes,
``work.train_step_flops``), over its wall time, the cards and the dense
bf16 peak (989 TFLOP/s), in percent."""

from benchmark.work import MFU_PEAK_FLOPS


def read(layer):
    u = layer.get("untraced")
    if not u or u["wall_s"] <= 0 or u["calls"] <= 0:
        return None
    return 100.0 * u["flops"] / (u["wall_s"] * layer["chips"] * MFU_PEAK_FLOPS)
