"""Tacotron 2 with GST (``gst_taco2``) on the CPU at small widths, against
the benchmark's plain reference (``benchmark/reference/taco2.py``, written
from NVIDIA's public equations, independent of the port):

* the port's ``LSTMCell`` is ``torch.nn.LSTMCell`` on shared weights (the
  gate order i, f, g, o and the two biases);
* the masked BiLSTM of the encoder against the reference's scan;
* the whole synthesis (``Synthesizer``, the plain routes the CPU takes) at
  LSTMs of 32, a memory of 48, attention 16, post-net channels 16, B = 3,
  12 decoder steps at r=1, seeded weights, prenet dropout on: the style,
  mel, stop logits, alignments, frame lengths, post-net mel and the
  pseudo-inverse linear amplitudes Griffin-Lim starts from;
* the preset's widths and the keys that select its modules.
"""

import numpy as np
import pytest
import torch

from gst_tacotron_tpu_torch.config import apply_overrides, get_preset, to_dict

torch.set_num_threads(2)

SMALL = {
    "audio.n_fft": 512, "audio.hop_length": 128, "audio.win_length": 512,
    "audio.griffin_lim_iters": 2, "model.num_freq": 257,
    "model.encoder.embedding_dim": 16, "model.encoder.cbhg_gru_dim": 16,
    "model.gst.ref_conv_channels": [4, 8], "model.gst.ref_gru_dim": 16,
    "model.gst.style_dim": 16, "model.gst.num_heads": 2,
    "model.attention.dim": 16, "model.attention.location_filters": 4,
    "model.attention.location_kernel_size": 7,
    "model.decoder.prenet_dims": [24, 16], "model.decoder.attention_rnn_dim": 32,
    "model.decoder.decoder_rnn_dim": 32, "model.decoder.max_decode_steps": 12,
    "model.decoder.stop_threshold": 1.0, "model.postnet.conv_channels": 16,
}
# float32 throughout on both sides, the same operations in another grouping
# (packed LSTM products and summed biases, the folded location taps against
# conv-then-dense, cuBLAS-free CPU sums): a few ulps a product, carried by
# the recurrences over 12 steps (the readings: at most 2.4e-7)
TOL = 2e-6


def _cfg():
    return apply_overrides(get_preset("gst_taco2"), SMALL)


def _weights(model, seed):
    """Seeded weights on every parameter and BatchNorm statistic, biases
    nonzero (the benchmark's draw)."""
    from benchmark import weights as bench_weights

    w = bench_weights.make({k: tuple(v.shape) for k, v in model.state_dict().items()}, seed,
                           "cpu")
    model.load_state_dict(w)
    return w


def test_lstm_cell_is_torchs():
    from gst_tacotron_tpu_torch.models.rnn import LSTMCell

    cell = LSTMCell(6, 5)
    _weights(cell, 3)
    ref = torch.nn.LSTMCell(6, 5)
    with torch.no_grad():
        ref.weight_ih.copy_(cell.kernel.T)
        ref.weight_hh.copy_(cell.recurrent_kernel.T)
        ref.bias_ih.copy_(cell.bias)
        ref.bias_hh.copy_(cell.recurrent_bias)
        g = torch.Generator().manual_seed(4)
        x, h, c = (torch.randn(3, n, generator=g) for n in (6, 5, 5))
        got, want = cell(x, (h, c)), ref(x, (h, c))
    # 1e-6: the same products, one rounding order apart
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_bilstm_against_the_reference():
    from benchmark.reference import taco2 as ref
    from gst_tacotron_tpu_torch.models.modules import mask_sequence
    from gst_tacotron_tpu_torch.models.rnn import BiLSTM

    rnn = BiLSTM(7, 6)
    w = {f"encoder.bilstm.{k}": v for k, v in _weights(rnn, 5).items()}
    g = torch.Generator().manual_seed(6)
    xs = torch.randn(4, 9, 7, generator=g)
    lengths = torch.tensor([9, 1, 5, 3])
    with torch.no_grad():
        got, _ = rnn(xs, lengths)
        want = torch.cat([ref.lstm(w, "encoder.bilstm.fwd", xs, lengths),
                          ref.lstm(w, "encoder.bilstm.bwd", xs, lengths, reverse=True)], -1)
    # 1e-6: one step's products, rounded in another order
    torch.testing.assert_close(mask_sequence(got, lengths), ref.mask(want, lengths),
                               atol=1e-6, rtol=0)


def test_synthesis_against_the_reference():
    from benchmark.reference import dsp, taco2
    from gst_tacotron_tpu_torch.models.tacotron import GSTTacotron
    from gst_tacotron_tpu_torch.synthesize import Synthesizer
    from gst_tacotron_tpu_torch.text import NUM_SYMBOLS

    cfg = _cfg()
    model = GSTTacotron(cfg.model, NUM_SYMBOLS)
    w = _weights(model, 11)
    assert model.memory_dim == 48
    rng = np.random.default_rng(12)
    texts = ["a quick test", "hello there you", "tts"]
    t = np.arange(4000) / cfg.audio.sample_rate
    wavs = [(np.sin(2 * np.pi * f * t) * 0.3 + rng.normal(0, 0.01, t.size)).astype(np.float32)
            for f in (110.0, 160.0, 220.0)]
    seed = 77
    out = Synthesizer(cfg, model, device="cpu")(texts, reference_wavs=wavs, seed=seed)
    a = to_dict(cfg)
    ref_mel, ref_len = dsp.reference_mels(wavs, a["audio"], "cpu", bf16=False)
    with torch.no_grad():
        want = taco2.synthesize(w, a, texts, ref_mel, ref_len, seed,
                                fed=torch.from_numpy(out["mel"]))
        amp = taco2.mel_to_linear(want["mel_postnet"], a["audio"])
    for key in ("style_embedding", "mel", "stop_logits", "alignments", "mel_postnet"):
        np.testing.assert_allclose(out[key], want[key].numpy(), atol=TOL, rtol=0,
                                   err_msg=key)
    np.testing.assert_array_equal(out["frame_lengths"], want["frame_lengths"].numpy())
    assert out["mel"].shape == (3, 12, 80) and "linear" not in out
    assert np.all(np.isfinite(out["wav"])) and out["wav"].shape == (3, 128 * 11)
    # the pseudo-inverse amplitudes Griffin-Lim starts from: relative, since
    # the amplitudes span the dB range (1e-5 of the largest)
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP

    got_amp = TorchDSP(cfg.audio, "cpu").mel_to_linear(torch.from_numpy(out["mel_postnet"]))
    assert float((got_amp - amp).abs().max() / amp.abs().max()) < 1e-5
    assert float(got_amp.min()) >= 1e-10


def test_preset_widths():
    cfg = get_preset("gst_taco2")
    m = cfg.model
    assert (m.encoder.kind, m.encoder.rnn, m.decoder.kind, m.postnet.kind) == \
        ("taco2", "lstm", "taco2", "conv")
    assert (m.encoder.embedding_dim, m.encoder.output_dim) == (512, 512)
    assert (m.attention.kind, m.attention.dim, m.attention.location_filters,
            m.attention.location_kernel_size) == ("location_sensitive", 128, 32, 31)
    assert (m.decoder.prenet_dims, m.decoder.attention_rnn_dim, m.decoder.decoder_rnn_dim,
            m.decoder.reduction_factor, m.decoder.max_decode_steps) == ((256, 256), 1024,
                                                                        1024, 1, 1000)
    assert (m.postnet.conv_layers, m.postnet.conv_channels, m.postnet.conv_kernel_size) == \
        (5, 512, 5)
    for preset in ("taco1_lj", "gst_lj", "gst_r1_location", "gst_multispeaker",
                   "gst_wavernn"):
        p = get_preset(preset).model
        assert (p.encoder.rnn, p.decoder.kind, p.postnet.kind) == ("gru", "taco1", "cbhg")


@pytest.mark.parametrize("key,value", [("model.decoder.kind", "taco3"),
                                       ("model.postnet.kind", "wavenet"),
                                       ("model.encoder.rnn", "rnn")])
def test_unknown_module_kinds_are_refused(key, value):
    from gst_tacotron_tpu_torch.models.tacotron import GSTTacotron

    cfg = apply_overrides(_cfg(), {key: value})
    with pytest.raises(ValueError, match="unknown"):
        GSTTacotron(cfg.model, 40)


def test_training_is_refused():
    from gst_tacotron_tpu_torch.models.tacotron import GSTTacotron

    cfg = _cfg()
    model = GSTTacotron(cfg.model, 40)
    with pytest.raises(NotImplementedError, match="synthesis only"):
        model(torch.zeros(2, 5, dtype=torch.int64), None, torch.zeros(2, 4, 80))
