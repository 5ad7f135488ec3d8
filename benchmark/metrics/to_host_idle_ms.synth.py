"""Milliseconds a profiled synthesis call in which the card was idle while
``gst.synth.to_host`` was open: the results' copies to the host, one
blocking copy an output (``Synthesizer.to_host``)."""

from benchmark.spans import of_run


def read(layer):
    s = of_run(layer)
    r = (s or {}).get("spans", {}).get("gst.synth.to_host")
    if not r:
        return None
    return 1e3 * r["idle_in_s"] / s["calls"]
