"""Share of Griffin-Lim's shape-only tables (the window-square norm, the
inverse preemphasis's three tables) that the program took from its
per-length cache (``dsp_table_hits``) rather than built
(``dsp_table_builds``), in percent over the process: a count, which repeats
exactly while the calls' shapes and code stay the same."""

from benchmark.spans import counters_of_run


def read(layer):
    c = counters_of_run(layer)
    if not c or "dsp_table_hits" not in c:
        return None
    return 100.0 * c["dsp_table_hits"] / (c["dsp_table_hits"] + c.get("dsp_table_builds", 0))
