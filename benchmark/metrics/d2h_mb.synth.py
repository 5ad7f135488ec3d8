"""Megabytes copied from the card to the host a synthesis call, as the
program counts them (``d2h_bytes``: the results in ``to_host`` and the
style wavs' features in ``DeviceFeatureExtractor.extract``), over the calls
it counted (``calls``): a count, which repeats exactly while the calls'
shapes and code stay the same."""

from benchmark.spans import counters_of_run


def read(layer):
    c = counters_of_run(layer)
    if not c or not c.get("calls") or "d2h_bytes" not in c:
        return None
    return c["d2h_bytes"] / c["calls"] / 1e6
