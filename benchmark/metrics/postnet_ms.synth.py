"""Device milliseconds a profiled synthesis call of the kernels, memcpys and
memsets launched inside ``gst.model.postnet``: the post-net
(``models/postnet.py``), Tacotron 2's conv stack or the CBHG (its BiGRU on
K1)."""

from benchmark.spans import of_run


def read(layer):
    s = of_run(layer)
    r = (s or {}).get("spans", {}).get("gst.model.postnet")
    if not r:
        return None
    return 1e3 * r["device_s"] / s["calls"]
