"""Share of the bytes copied from the card to the host whose copy the
program enqueued before the vocoder's first launch (``d2h_early_bytes``:
the results that are final once the post-net returns, copied while the
vocoder computes), over every byte it copied (``d2h_bytes``), in percent
over the process: a count, which repeats exactly while the calls' shapes
and code stay the same."""

from benchmark.spans import counters_of_run


def read(layer):
    c = counters_of_run(layer)
    if not c or "d2h_early_bytes" not in c or not c.get("d2h_bytes"):
        return None
    return 100.0 * c["d2h_early_bytes"] / c["d2h_bytes"]
