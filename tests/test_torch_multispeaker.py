"""gst_multispeaker (the speaker embedding) in synthesis on the CPU, at the
small widths of tests/test_train_smoke.py::small_cfg with 3 speakers of
width 8: the port's ``Synthesizer`` against the JAX ``Synthesizer`` at
``deterministic_prenet=True`` with the JAX init carried over; another
speaker gives another mel. Its train step is held in
tests/test_torch_train_parity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gst_tacotron_tpu.synthesize import Synthesizer as JSynthesizer
from gst_tacotron_tpu.train import build_model as jbuild
from gst_tacotron_tpu_torch.synthesize import Synthesizer
from gst_tacotron_tpu_torch.weights import build_model

from tests.test_torch_synth_configs import flatten_tree
from tests.test_torch_train_parity import load_config_from_jax
from tests.test_train_smoke import small_cfg

torch.set_num_threads(2)


def test_multispeaker_synthesizer_matches_jax():
    """Speaker ids reach the memory through the embedding in synthesis too."""
    jcfg = small_cfg("gst_multispeaker", **{"model.num_speakers": 3,
                                            "model.speaker_dim": 8,
                                            "model.decoder.stop_threshold": 1.5,
                                            "audio.griffin_lim_bf16": False})
    cfg = load_config_from_jax(jcfg)
    model = jbuild(jcfg)
    variables = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(0)},
        jnp.zeros((1, 8), jnp.int32), jnp.array([8]), jnp.zeros((1, 16, 80)),
        ref_mel=jnp.zeros((1, 16, 80)), ref_mel_lengths=jnp.array([16]),
        speaker_ids=jnp.zeros((1,), jnp.int32)))()
    flat = flatten_tree({"params": variables["params"],
                         "batch_stats": variables["batch_stats"]})
    texts, speakers = ["speaker one.", "and speaker two here."], [1, 2]
    ref = JSynthesizer(jcfg, model, variables, deterministic_prenet=True)(
        texts, speaker_ids=speakers, max_steps=6)
    ts = Synthesizer(cfg, build_model(cfg, flat=flat, device="cpu"), device="cpu",
                     deterministic_prenet=True)
    got = ts(texts, speaker_ids=speakers, max_steps=6)
    other = ts(texts, max_steps=6)                        # speaker 0 for both
    assert got["mel"].shape == ref["mel"].shape == (2, 12, 80)
    np.testing.assert_allclose(got["mel"], ref["mel"], atol=1e-4)
    np.testing.assert_allclose(got["alignments"], ref["alignments"], atol=1e-4)
    assert not np.allclose(got["mel"], other["mel"])
