"""Train steps of the port on a (2, 2) mesh on the CPU: four gloo ranks
(``tests/torch_dist_workers.py``), data and tensor parallel at once, on
tests/test_torch_parallel_train.py's setup (small_cfg's gst_lj widths,
prenet dropout on, 3 steps, shards of very different valid lengths) and at
its budgets against the single-process port step on the same global
batches."""

import numpy as np
import pytest
import torch

from tests.test_torch_parallel_train import (STEPS, assert_matches, global_batch,
                                             port_config, single_process)
from tests.torch_dist_workers import run_ranks

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = port_config(tmp_path_factory)
    rng = np.random.default_rng(0)
    batches = [global_batch(rng) for _ in range(STEPS)]
    return single_process(cfg, batches), run_ranks("train_steps", 4, cfg, (2,), batches)


def test_data_and_tensor_parallel_steps_match_the_single_process_step(runs):
    ref, ranks = runs
    got = ranks[0][0]
    assert "decoder.cell.frame_proj.kernel" in got["sharded"]
    assert_matches(ref, got)
    assert all(r == [None] for r in ranks[1:])
