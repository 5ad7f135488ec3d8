"""Device milliseconds a profiled synthesis call of the kernels, memcpys and
memsets launched inside ``gst.synth.vocoder``: Griffin-Lim
(``dsp/torch_dsp.py``) where the configuration vocodes with it."""

from benchmark.spans import of_run


def read(layer):
    s = of_run(layer)
    r = (s or {}).get("spans", {}).get("gst.synth.vocoder")
    if not r:
        return None
    return 1e3 * r["device_s"] / s["calls"]
