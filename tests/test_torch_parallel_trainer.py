"""``train.Trainer`` under a (2, 1) mesh on the CPU, two gloo ranks
(``tests/torch_dist_workers.py``), with the device corpus (the wav
transport; the whole corpus on every rank, each rank's batches indexing
its rows): each rank's loader takes its shard of every global batch, and
the losses of 2 steps equal the single-process ``Trainer``'s within 1e-5
relative, prenet dropout on."""

import numpy as np
import pytest
import torch

from gst_tacotron_tpu_torch.data import generate_patterns, synthetic_utterances
from gst_tacotron_tpu_torch.train import Trainer

from tests.test_torch_parallel_train import port_config
from tests.torch_dist_workers import run_ranks

torch.set_num_threads(2)

STEPS = 2
FAST = {"audio.hop_length": 256, "data.buckets": [[64, 320]], "data.val_fraction": 0.0,
        "data.batch_size": 4, "data.wav_transport": True, "data.device_corpus": True}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = port_config(tmp_path_factory, **FAST)
    patterns = str(tmp_path_factory.mktemp("patterns"))
    generate_patterns(synthetic_utterances(8), cfg.audio, patterns, store_wav=True)
    single = []
    trainer = Trainer(cfg, patterns, str(tmp_path_factory.mktemp("single")), device="cpu")
    trainer.train(STEPS, on_step=lambda tr, step, m, frames: single.append(float(m["loss"])))
    ranks = run_ranks("trainer_losses", 2, cfg, patterns,
                      str(tmp_path_factory.mktemp("dp")), STEPS)
    return single, ranks


def test_device_corpus_trainer_matches_the_single_process_trainer(runs):
    single, ranks = runs
    assert len(single) == STEPS
    for losses in ranks:
        np.testing.assert_allclose(losses, single, rtol=1e-5)
