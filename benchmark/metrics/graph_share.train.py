"""Share of the train steps (``calls``) that the program ran as a replay of
its captured CUDA graph (``train_graph_replays``), in percent: a count,
which repeats exactly while the steps' shapes and code stay the same."""

from benchmark.spans import counters_of_run


def read(layer):
    c = counters_of_run(layer)
    if not c or not c.get("calls") or "train_graph_replays" not in c:
        return None
    return 100.0 * c["train_graph_replays"] / c["calls"]
