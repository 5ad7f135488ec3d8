"""A rank of the data-parallel driver at small widths on the CPU, for the
tests: ``python dp_worker.py <fault> <rank args>``; the fault ``none`` or
``no_gather`` (each rank keeps its own rows: the exchange left out) or
``jax_on_rank1`` (rank 1 loads a module named ``jax``)."""

import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

import small  # noqa: E402
from benchmark import common  # noqa: E402
from benchmark.drivers import dp_synth  # noqa: E402


def no_gather():
    import gst_tacotron_tpu_torch.parallel.distributed_synthesis as ds

    ds.all_gather = lambda t, group, dim=0: t


if __name__ == "__main__":
    torch.set_num_threads(1)
    if sys.argv[1] == "no_gather":
        no_gather()
    if sys.argv[1] == "jax_on_rank1" and sys.argv[sys.argv.index("--rank") + 1] == "1":
        sys.modules["jax"] = types.ModuleType("jax")
    # the cell is read from its workload file, listed in BENCHMARK.json or not
    common.load_cell = lambda cell: ({"name": cell, "chips": 4}, {
        **common.read_json(common.HERE / "workloads" / f"{cell}.json"), "traffic": small.DP_MIX})
    sys.exit(dp_synth.worker(sys.argv[2:], *small.config()))
