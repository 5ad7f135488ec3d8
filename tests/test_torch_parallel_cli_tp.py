"""The train CLI at ``--model-parallelism 2`` as two processes on the CPU
(tests/test_torch_parallel_cli.py's setup, a (1, 2) mesh: the ruled
kernels stored sharded):

* the logged losses equal the single-process CLI's within 1e-5 relative;
* rank 0 writes the one checkpoint;
* that checkpoint, the whole state with the shards gathered, restores in
  one process bit for bit, at the single-process shapes.
"""

import os

import numpy as np
import pytest
import torch

from gst_tacotron_tpu_torch.checkpoint import CheckpointManager
from gst_tacotron_tpu_torch.config import load_config
from gst_tacotron_tpu_torch.train import Trainer, state_dict

from tests.test_torch_parallel_cli import LOSS_TOL, STEPS, losses, run_cli

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return run_cli(tmp_path_factory, "tp", ["--model-parallelism", "2"])


def test_two_processes_reproduce_the_single_process_losses(setup):
    root, _, _ = setup
    np.testing.assert_allclose(losses(root / "tp"), losses(root / "single"), rtol=LOSS_TOL)


def test_rank_zero_writes_one_checkpoint(setup):
    root, _, _ = setup
    assert sorted(os.listdir(root / "tp" / "checkpoints")) == [f"step_{STEPS:08d}.pt"]


def test_tensor_parallel_checkpoint_restores_in_one_process(setup, tmp_path):
    root, cfg_path, patterns = setup
    saved = CheckpointManager(str(root / "tp" / "checkpoints")).restore()
    trainer = Trainer(load_config(cfg_path), patterns, str(root / "tp"), device="cpu")
    assert trainer.restore_if_available()
    got = state_dict(trainer.state)
    assert got["step"] == saved["step"] == STEPS
    assert got["opt"]["count"] == saved["opt"]["count"] and got["rng"] == saved["rng"]
    trees = [(got["model"], saved["model"])] + [(got["opt"][m], saved["opt"][m])
                                               for m in ("mu", "nu")]
    for mine, theirs in trees:
        assert mine.keys() == theirs.keys()
        for k in theirs:
            assert torch.equal(mine[k], theirs[k]), k
    # the whole kernels, as the single-process run holds them
    single = CheckpointManager(str(root / "single" / "checkpoints")).restore()
    for k, v in single["model"].items():
        assert got["model"][k].shape == v.shape, k
