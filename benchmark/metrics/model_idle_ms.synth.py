"""Milliseconds a profiled synthesis call in which the card was idle while
``gst.synth.infer`` was open, at any depth: the model's stages
(``gst.model.*``) and the vocoder (``gst.synth.vocoder``), their launch gaps
and Griffin-Lim's Python loop."""

from benchmark.spans import of_run


def read(layer):
    s = of_run(layer)
    r = (s or {}).get("spans", {}).get("gst.synth.infer")
    if not r:
        return None
    return 1e3 * r["idle_in_s"] / s["calls"]
