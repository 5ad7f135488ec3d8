"""The train CLI's multi-process flags on the CPU (the counterpart of
tools/multiproc_train.py): ``python -m gst_tacotron_tpu_torch.train ...
--coordinator localhost:PORT --num-processes 2 --process-id i`` as two
processes over gloo (``tests/torch_dist_workers.py``), small widths, prenet
dropout on, 2 steps, data parallel (a (2, 1) mesh):

* the logged losses equal the single-process CLI's within 1e-5 relative;
* rank 0 writes the one checkpoint (no other rank's copy, no temporary
  file).

tests/test_torch_parallel_cli_tp.py runs ``--model-parallelism 2``.
"""

import json
import os

import numpy as np
import pytest
import torch

from gst_tacotron_tpu.config import save_config
from gst_tacotron_tpu_torch.config import load_config
from gst_tacotron_tpu_torch.data import generate_patterns, synthetic_utterances
from gst_tacotron_tpu_torch.parallel.mesh import free_port
from gst_tacotron_tpu_torch.train import main

from tests.test_train_smoke import small_cfg
from tests.torch_dist_workers import run_ranks

torch.set_num_threads(2)

STEPS = 2
LOSS_TOL = 1e-5
OVERRIDES = {"audio.hop_length": 256, "data.buckets": [[64, 320]], "data.val_fraction": 0.0,
             "data.batch_size": 4, "train.log_every": 1}


def run_cli(tmp_path_factory, mode, extra):
    """The single-process CLI and the two-process one with ``extra`` flags
    (into workdirs "single" and ``mode``) -> (root, config path, patterns)."""
    root = tmp_path_factory.mktemp("cli")
    cfg_path = str(root / "config.json")
    save_config(small_cfg("gst_lj", **OVERRIDES), cfg_path)
    patterns = str(root / "patterns")
    generate_patterns(synthetic_utterances(8), load_config(cfg_path).audio, patterns,
                      store_wav=True)

    def argv(work):
        return ["--config", cfg_path, "--patterns", patterns, "--workdir", str(root / work),
                "--steps", str(STEPS), "--device", "cpu"]

    main(argv("single"))
    run_ranks("train_cli", 2, argv(mode) + extra + [
        "--coordinator", f"localhost:{free_port()}", "--num-processes", "2"], join=False)
    return root, cfg_path, patterns


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return run_cli(tmp_path_factory, "dp", [])


def losses(work):
    with open(os.path.join(work, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["train/loss"] for r in recs if "train/loss" in r]


def test_two_processes_reproduce_the_single_process_losses(setup):
    root, _, _ = setup
    ref = losses(root / "single")
    assert len(ref) == STEPS
    np.testing.assert_allclose(losses(root / "dp"), ref, rtol=LOSS_TOL)


def test_rank_zero_writes_one_checkpoint(setup):
    root, _, _ = setup
    assert sorted(os.listdir(root / "dp" / "checkpoints")) == [f"step_{STEPS:08d}.pt"]
