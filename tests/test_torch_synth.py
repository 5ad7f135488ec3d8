"""The slice end to end on the CPU: the port's ``Synthesizer`` against the JAX
``Synthesizer`` at ``deterministic_prenet=True`` on the tiny golden pack
(text_0, text_1, ref_wav_0 with tests/fixtures/golden/params.npz), within
the golden gate's budgets (mel MAE < 1e-4, allclose atol 1e-3, MCD < 0.1 dB;
tests/test_golden_fixtures.py), with equal frame lengths. Both sides run
Griffin-Lim with griffin_lim_bf16=False, and the waveforms agree to 1e-3 of
their peak (float32 FFTs against the JAX real-pair DFT products, through two
Griffin-Lim iterations and the inverse preemphasis); at the pack's own
setting (True) both iterate on bfloat16 operands, and the waveforms agree to
5e-3 of their peak (measured up to 1.04e-3 on the three packs: a float32 sum
in another order can flip a bfloat16 rounding at the next iteration)."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.config import apply_overrides as japply
from gst_tacotron_tpu.config import load_config as jload
from gst_tacotron_tpu.metrics import mel_cepstral_distortion
from gst_tacotron_tpu.synthesize import Synthesizer as JSynthesizer
from gst_tacotron_tpu.train import build_model as jbuild
from gst_tacotron_tpu_torch.config import apply_overrides, load_config
from gst_tacotron_tpu_torch.synthesize import Synthesizer
from gst_tacotron_tpu_torch.weights import build_model

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "tools"))
from make_golden_fixtures import unflatten_tree  # noqa: E402

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
FIXTURES = ["text_0", "text_1", "ref_wav_0"]


def assert_slice_close(got, ref, wav_tol=1e-3):
    np.testing.assert_array_equal(got["frame_lengths"], ref["frame_lengths"])
    for b in range(got["mel"].shape[0]):
        frames = int(ref["frame_lengths"][b])
        g, r = got["mel"][b, :frames], ref["mel"][b, :frames]
        err = np.abs(g - r)
        assert err.mean() < 1e-4, err.mean()
        assert np.allclose(g, r, atol=1e-3), err.max()
        assert mel_cepstral_distortion(g, r) < 0.1
    assert got["wav"].shape == ref["wav"].shape
    np.testing.assert_allclose(got["wav"], ref["wav"], atol=wav_tol * np.abs(ref["wav"]).max())


def golden_synths(overrides):
    """The JAX and the port's Synthesizer on the golden pack, its config
    with ``overrides`` on both sides."""
    with np.load(os.path.join(GOLDEN, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    jcfg = japply(jload(os.path.join(GOLDEN, "config.json")), overrides)
    variables = jax.tree_util.tree_map(jax.numpy.asarray, unflatten_tree(flat))
    js = JSynthesizer(jcfg, jbuild(jcfg), variables, deterministic_prenet=True)
    cfg = apply_overrides(load_config(os.path.join(GOLDEN, "config.json")), overrides)
    ts = Synthesizer(cfg, build_model(cfg, flat=flat, device="cpu"), device="cpu",
                     deterministic_prenet=True)
    return js, ts


@pytest.fixture(scope="module")
def synths():
    return golden_synths({"audio.griffin_lim_bf16": False})


@pytest.fixture(scope="module")
def synths_bf16():
    return golden_synths({})


def check_golden_pack(js, ts, name, wav_tol=1e-3):
    with np.load(os.path.join(GOLDEN, f"{name}.npz")) as z:
        text = str(z["text"])
        refs = [z["ref_wav"]] if "ref_wav" in z else None
    ref = js([text], reference_wavs=refs, seed=0)
    got = ts([text], reference_wavs=refs, seed=0)
    assert_slice_close(got, ref, wav_tol)
    np.testing.assert_allclose(got["style_embedding"], ref["style_embedding"], atol=1e-5)
    np.testing.assert_allclose(got["diagonality"], ref["diagonality"], atol=1e-5)


@pytest.mark.parametrize("name", FIXTURES)
def test_golden_pack_matches_jax_synthesizer(synths, name):
    check_golden_pack(*synths, name)


@pytest.mark.parametrize("name", FIXTURES)
def test_golden_pack_matches_jax_at_default_griffin_lim_bf16(synths_bf16, name):
    js, ts = synths_bf16
    assert ts.cfg.audio.griffin_lim_bf16 and js.cfg.audio.griffin_lim_bf16
    check_golden_pack(js, ts, name, wav_tol=5e-3)


def test_token_weights_batch_matches_jax_synthesizer(synths):
    js, ts = synths
    texts = ["the quick brown fox.", "golden fixtures pin synthesis output."]
    w = np.zeros((2, 10), np.float32)
    w[0, 3], w[1, 7] = 1.0, 1.0
    ref = js(texts, token_weights=w, seed=0)
    got = ts(texts, token_weights=w, seed=0)
    assert_slice_close(got, ref)
