"""The WaveRNN vocoder under a mesh on the CPU, two gloo ranks
(``tests/torch_dist_workers.py``), gst_wavernn at small widths:

* ``VocoderTrainer`` steps at dp=2 and at tp=2 (the WaveRNN's ruled
  kernels stored sharded) against the single-process trainer's steps on the
  same global batches: losses and ``grad_norm`` within 1e-5 relative,
  parameters within 5e-5 after 2 steps (Adam; see
  tests/test_torch_parallel_train.py);
* the plain WaveRNN sampler at dp=2, each rank sampling its rows with the
  Gumbel noise of their rows of the global batch, gives the single-process
  classes exactly.
"""

import numpy as np
import pytest
import torch

from gst_tacotron_tpu_torch.data import generate_patterns, synthetic_utterances
from gst_tacotron_tpu_torch.vocoder_train import VocoderTrainer
from gst_tacotron_tpu_torch.weights import build_wavernn

from tests.test_torch_parallel_train import port_config
from tests.torch_dist_workers import run_ranks

torch.set_num_threads(2)

LOSS_TOL = 1e-5
PARAM_ATOL = 5e-5
SEGMENT = 4
MESHES = {"dp2": 1, "tp2": 2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = port_config(tmp_path_factory, "gst_wavernn", **{
        "model.vocoder.wavernn_gru_dim": 16, "model.vocoder.wavernn_fc_dim": 16,
        "model.vocoder.wavernn_hop": 128})
    patterns = str(tmp_path_factory.mktemp("patterns"))
    generate_patterns(synthetic_utterances(3), cfg.audio, patterns, store_wav=True)
    rng = np.random.default_rng(0)
    hop = cfg.audio.hop_length
    batches = [{"mel": rng.uniform(0, 1, (4, SEGMENT, 80)).astype(np.float16),
                "wav": rng.uniform(-0.9, 0.9, (4, SEGMENT * hop)).astype(np.float16)}
               for _ in range(2)]
    mel = rng.uniform(0, 1, (4, 3, 80)).astype(np.float32)
    got = run_ranks("calls", 2, [("vocoder_steps", (cfg, tuple(MESHES.values()), patterns,
                                                    batches)),
                                 ("wavernn_sample", (cfg, mel, 11))])
    single = VocoderTrainer(cfg, patterns, str(tmp_path_factory.mktemp("w")), device="cpu",
                            segment_frames=SEGMENT, batch_size=4)
    ref = {"metrics": [{k: float(v) for k, v in single.step(b).items()} for b in batches],
           "model": {k: v.detach().numpy() for k, v in single.model.state_dict().items()}}
    with torch.no_grad():
        classes = build_wavernn(cfg, seed=1, device="cpu").sample_classes(
            torch.from_numpy(mel), seed=11).numpy()
    return ref, dict(zip(MESHES, got[0][0])), classes, [r[1] for r in got]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_vocoder_trainer_steps_match_the_single_process_steps(runs, mesh):
    ref, got, _, _ = runs
    got = got[mesh]
    for step, (r, g) in enumerate(zip(ref["metrics"], got["metrics"])):
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=LOSS_TOL, err_msg=f"step {step} {k}")
    assert ref["model"].keys() == got["model"].keys()
    for k, r in ref["model"].items():
        np.testing.assert_allclose(got["model"][k], r, atol=PARAM_ATOL, rtol=0, err_msg=k)
    if mesh == "tp2":
        assert {"gru.kernel", "gru.recurrent_kernel", "fc1.kernel", "fc2.kernel",
                "cond_proj.kernel"} == set(got["sharded"])


def test_data_parallel_sampler_gives_the_single_process_classes(runs):
    _, _, classes, ranks = runs
    for got in ranks:
        np.testing.assert_array_equal(got, classes)
