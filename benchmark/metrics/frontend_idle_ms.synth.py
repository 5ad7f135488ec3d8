"""Milliseconds a profiled synthesis call in which the card was idle while
the innermost of the program's open spans was the host front end's: the
texts (``gst.synth.frontend``), the style wavs' mels (``gst.synth.ref_mels``
and the extractor's ``gst.features.*``) and the inputs' copies to the card
(``gst.synth.h2d``)."""

from benchmark.spans import of_run

FRONT_END = ("gst.synth.frontend", "gst.synth.ref_mels", "gst.synth.h2d")


def read(layer):
    s = of_run(layer)
    if not s or not s["calls"]:
        return None
    idle = sum(r["idle_s"] for name, r in s["spans"].items()
               if name in FRONT_END or name.startswith("gst.features."))
    return 1e3 * idle / s["calls"]
