"""The plain reference against the port's plain path at small widths, on
the CPU: the style wavs' mels, Griffin-Lim, the Philox streams, a whole
synthesis running free (dropout on), and WaveRNN sampling."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import small
from benchmark import weights
from benchmark.reference import dsp, philox, tacotron, wavernn
from benchmark.traffic import synth as traffic

torch.set_num_threads(2)


def _audio(cfg):
    from gst_tacotron_tpu_torch.config import to_dict

    return to_dict(cfg)["audio"]


@pytest.mark.parametrize("bf16", [False, True])
def test_style_wav_mels(bf16):
    from gst_tacotron_tpu_torch.dsp.device_features import DeviceFeatureExtractor

    cfg, _ = small.config()
    wavs = traffic.batches(small.MIX, 4, cfg.audio.sample_rate)[0][1]
    ex = DeviceFeatureExtractor(cfg.audio, "cpu", bf16=bf16)
    got = [m for m, _ in ex.extract(wavs)]
    ref, lengths = dsp.reference_mels(wavs, _audio(cfg), "cpu", bf16=bf16)
    for i, m in enumerate(got):
        assert int(lengths[i]) == m.shape[0]
        np.testing.assert_allclose(ref[i, : m.shape[0]].numpy(), m, atol=2e-5)
    assert ref.shape[1] % 64 == 0 and float(ref[0, int(lengths[0]):].abs().max()) == 0.0


@pytest.mark.parametrize("bf16", [False, True])
def test_griffin_lim(bf16):
    import dataclasses

    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP

    cfg, _ = small.config()
    a = dataclasses.replace(cfg.audio, griffin_lim_bf16=bf16)
    lin = torch.rand(2, 12, cfg.model.num_freq, generator=torch.Generator().manual_seed(0))
    got = TorchDSP(a, "cpu").inv_linear_spectrogram(lin).numpy()
    ref = dsp.GriffinLim({**_audio(cfg), "griffin_lim_bf16": bf16}, "cpu")(lin)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_philox_streams():
    from gst_tacotron_tpu_torch.ops.philox import stream_uniforms

    steps = torch.arange(3, 9)
    for seed in (0, 7, 2 ** 40 + 3):
        for stream in (0, 1, 2):
            assert torch.equal(philox.uniforms(seed, steps, stream, 5, 13, row0=4),
                               stream_uniforms(seed, steps, stream, 5, 13, row0=4))


def _model(cfg, seed=5):
    from gst_tacotron_tpu_torch.models.tacotron import GSTTacotron
    from gst_tacotron_tpu_torch.text import NUM_SYMBOLS

    model = GSTTacotron(cfg.model, NUM_SYMBOLS)
    w = weights.make({k: tuple(v.shape) for k, v in model.state_dict().items()}, seed, "cpu")
    model.load_state_dict(w)
    return model.eval(), w


@pytest.mark.parametrize("kind", ["bahdanau", "location_sensitive"])
def test_free_running_synthesis(kind):
    """The reference decoding its own frames against the port's plain
    ``infer`` (dropout on), stage by stage."""
    from gst_tacotron_tpu_torch.config import apply_overrides, to_dict

    cfg, spec = small.config()
    cfg = apply_overrides(cfg, {"model.attention.kind": kind})
    model, w = _model(cfg)
    texts, wavs = traffic.batches(small.MIX, 6, cfg.audio.sample_rate)[0]
    cd = to_dict(cfg)
    ref_mel, ref_len = dsp.reference_mels(wavs, cd["audio"], "cpu", bf16=False)
    ids, lens = tacotron.text_ids(texts, 32)
    with torch.no_grad():
        got = model.infer(torch.from_numpy(ids), torch.from_numpy(lens), ref_mel, ref_len,
                          seed=11, plain=True, bf16=False)
        ref = tacotron.synthesize(w, cd, texts, ref_mel, ref_len, 11)
    for k in ("style_embedding", "mel", "stop_logits", "alignments", "linear"):
        torch.testing.assert_close(ref[k], got[k], atol=2e-5, rtol=1e-4)
    assert torch.equal(ref["frame_lengths"], got["frame_lengths"])


def test_wavernn_sampling_reads_no_gap():
    """The port's plain sampler's classes score as the best class of every
    step under the reference; a class moved off it reads a gap."""
    from gst_tacotron_tpu_torch.models.wavernn import WaveRNN
    from gst_tacotron_tpu_torch.ops.wavernn import wavernn_sample_plain

    cfg, _ = small.config("gst_wavernn")
    voc = WaveRNN(cfg.model.vocoder, cfg.model.num_mels)
    w = weights.make({k: tuple(v.shape) for k, v in voc.state_dict().items()}, 3, "cpu")
    voc.load_state_dict(w)
    mel = torch.rand(3, 4, cfg.model.num_mels, generator=torch.Generator().manual_seed(1))
    hop = cfg.model.vocoder.wavernn_hop
    with torch.no_grad():
        classes = wavernn_sample_plain(voc.pack(), voc.cond_frames(mel), hop=hop, seed=77)
        kw = dict(hop=hop, seed=77, rows=[0, 2])
        assert wavernn.widest_gap(w, mel, classes, **kw) <= 1e-5
        wav = voc.sample(mel, seed=77, plain=True).numpy()
        back = torch.from_numpy(wavernn.mulaw_classes(wav, cfg.model.vocoder.wavernn_bits))
        assert torch.equal(back, classes.to(torch.int64))
        moved = classes.clone()
        moved[:, 17] = (moved[:, 17] + 5) % 64
        picks = moved[[0, 2]].to(torch.int64)
        assert wavernn.widest_gap(w, mel, classes, picks=picks, **kw) > 1e-3
