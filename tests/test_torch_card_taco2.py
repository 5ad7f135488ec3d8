"""Tacotron 2 with GST (``gst_taco2``) on the card:

* K4's LSTM branch against ``decode_scan_plain`` at the preset's widths (B =
  32, 192 memory positions, LSTMs of 1024, attention 128, 50 steps, dropout
  on), the same bits on a second run, one launch counted on the ``lstm``
  branch and its steps in ``decode_steps``; at ragged widths over two row
  groups within 1e-5; resumed in chunks, the bits of one call;
* the encoder's BiLSTM on the library (cuDNN, TF32 off) against its plain
  scans;
* ``Synthesizer`` on the preset (decode cut short): K4 once on the LSTM
  branch and no K1 launch beside the reference GRU's, the outputs' shapes,
  the kernel path within 2e-3 of the plain path's mels; the teacher-forced
  pass refuses the configuration.

Needs an NVIDIA GPU and nvcc; skipped without a card. Imports no JAX
(tests/test_torch_cuda.py gives the card command).
"""

import numpy as np
import pytest
import torch

from test_torch_cuda import dev  # noqa: F401 (the card fixture)

pytestmark = pytest.mark.cuda


def _cell(cfg, dev, seed):
    from gst_tacotron_tpu_torch.models.decoder import Taco2DecoderCell
    from gst_tacotron_tpu_torch.weights import init_weights

    m = cfg.model
    cell = Taco2DecoderCell(m.decoder, m.attention, m.num_mels,
                            m.encoder.output_dim + m.gst.style_dim)
    init_weights(cell, seed=seed)
    with torch.no_grad():      # nonzero biases, so each bias term shows
        for prm in cell.parameters():
            if prm.dim() == 1:
                prm.add_(0.1 * torch.randn(prm.shape, generator=torch.Generator()
                                           .manual_seed(seed)))
    return cell.to(dev)


def _memory(cell, b, t, dev, seed):
    rng = np.random.default_rng(seed)
    memory = torch.from_numpy(rng.normal(0, 0.5, (b, t, cell.memory_dim)).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        keys = cell.precompute_keys(memory).contiguous()
    lens = rng.integers(t // 2, t + 1, b)
    lens[0], lens[-1] = t, 1
    return memory, keys, torch.from_numpy(lens).to(dev)


# 50 steps at the preset's widths. 1e-4: float32 sums of up to 1792 terms in
# another order, carried by the cell states and the cumulative alignment
# through every step (1e-5 holds at 4 steps, below)
def test_lstm_decode_at_the_presets_widths(dev):
    from gst_tacotron_tpu_torch.config import get_preset
    from gst_tacotron_tpu_torch.ops.decode import KERNEL, decode_scan, decode_scan_plain
    from gst_tacotron_tpu_torch.utils import profiling

    cfg = get_preset("gst_taco2")
    cell = _cell(cfg, dev, 3)
    memory, keys, lengths = _memory(cell, 32, 192, dev, 4)
    packed = cell.pack()
    kw = dict(dec_cfg=cfg.model.decoder, attn_cfg=cfg.model.attention,
              num_mels=cfg.model.num_mels, steps=50, seed=7, use_dropout=True)
    before, branch = KERNEL.launches, KERNEL.branch_launches["lstm"]
    steps = profiling.counters().get("decode_steps", 0)
    with torch.no_grad():
        got = decode_scan(packed, memory, keys, lengths, **kw)
        again = decode_scan(packed, memory, keys, lengths, **kw)
        ref = decode_scan_plain(packed, memory, keys, lengths, **kw)
        other = decode_scan(packed, memory, keys, lengths, **dict(kw, seed=8))
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 3 and KERNEL.branch_launches["lstm"] == branch + 3
    assert profiling.counters()["decode_steps"] == steps + 4 * 50
    for x, y, z in zip(got, ref, again):
        assert bool(torch.isfinite(x).all())
        torch.testing.assert_close(x, y, atol=1e-4, rtol=0)
        assert torch.equal(x, z)
    assert not torch.equal(got[0], other[0])


@pytest.mark.parametrize("use_dropout", [False, True])
def test_lstm_decode_at_ragged_widths(dev, use_dropout):
    """Widths off every multiple of 4 (each product's input padded), 35 rows
    (two row groups), lengths 0 and 1: within 1e-5 of the plain version."""
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
    from gst_tacotron_tpu_torch.ops.decode import decode_scan, decode_scan_plain

    cfg = apply_overrides(get_preset("gst_taco2"), {
        "model.decoder.prenet_dims": [15, 9], "model.decoder.attention_rnn_dim": 13,
        "model.decoder.decoder_rnn_dim": 22, "model.attention.dim": 11,
        "model.attention.location_filters": 5, "model.attention.location_kernel_size": 7,
        "model.num_mels": 7, "model.encoder.cbhg_gru_dim": 5, "model.gst.style_dim": 9})
    cell = _cell(cfg, dev, 9)
    memory, keys, _ = _memory(cell, 35, 37, dev, 10)
    lengths = torch.tensor(([37, 0, 1, 20, 5] * 7)[:35], device=dev)
    kw = dict(dec_cfg=cfg.model.decoder, attn_cfg=cfg.model.attention, num_mels=7, steps=8,
              seed=17, use_dropout=use_dropout)
    with torch.no_grad():
        got = decode_scan(cell.pack(), memory, keys, lengths, **kw)
        ref = decode_scan_plain(cell.pack(), memory, keys, lengths, **kw)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_lstm_decode_resumes_in_chunks(dev, chunk):
    """One launcher call a chunk over 150 steps, each resuming the carried
    workspace (its cell states too), gives the bits of one call."""
    from gst_tacotron_tpu_torch.config import get_preset
    from gst_tacotron_tpu_torch.ops.decode import decode_carry, decode_scan

    cfg = get_preset("gst_taco2")
    cell = _cell(cfg, dev, 5)
    memory, keys, lengths = _memory(cell, 32, 64, dev, 6)
    packed = cell.pack()
    kw = dict(dec_cfg=cfg.model.decoder, attn_cfg=cfg.model.attention,
              num_mels=cfg.model.num_mels, seed=9, use_dropout=True)
    with torch.no_grad():
        one = decode_scan(packed, memory, keys, lengths, steps=150, **kw)
        carry = decode_carry(memory, dec_cfg=cfg.model.decoder, num_mels=cfg.model.num_mels,
                             total_steps=150)
        s = 0
        while s < 150:
            n = min(chunk, 150 - s)
            decode_scan(packed, memory, keys, lengths, steps=n, carry=carry, **kw)
            s += n
    for x, y in zip((carry.mel, carry.stop_logits, carry.aligns), one):
        assert torch.equal(x, y)


def test_bilstm_on_the_library(dev):
    """The encoder's BiLSTM at the preset's width (512 -> 2 x 256), 32 rows
    of up to 192 steps: the library route within 1e-4 of the plain scans at
    the valid steps (float32 sums in cuDNN's order over 192 steps), the
    same bits twice."""
    from gst_tacotron_tpu_torch.models.modules import mask_sequence
    from gst_tacotron_tpu_torch.models.rnn import BiLSTM
    from gst_tacotron_tpu_torch.weights import init_weights

    rnn = BiLSTM(512, 256)
    init_weights(rnn, seed=2)
    rnn = rnn.to(dev)
    g = torch.Generator().manual_seed(3)
    xs = torch.randn(32, 192, 512, generator=g).to(dev)
    lengths = torch.randint(1, 193, (32,), generator=g).to(dev)
    lengths[0] = 192
    with torch.no_grad():
        lib, _ = rnn(xs, lengths)
        lib2, _ = rnn(xs, lengths)
        plain, _ = rnn(xs, lengths, plain=True)
    torch.testing.assert_close(mask_sequence(lib, lengths), mask_sequence(plain, lengths),
                               atol=1e-4, rtol=0)
    assert torch.equal(lib, lib2)


def test_taco2_synthesis_on_the_card(dev):
    """One batch of 8 through ``Synthesizer`` at the preset (24 steps, stop
    threshold 1.0): K4 once on the LSTM branch, K1 once (the reference GRU:
    the encoder's BiLSTM is the library's), K2 and K3 in their bf16
    branches; finite outputs of the expected shapes; with the prenets
    deterministic, the mels within 2e-3 of the plain path's. The
    teacher-forced pass refuses the configuration."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
    from gst_tacotron_tpu_torch.synthesize import Synthesizer
    from gst_tacotron_tpu_torch.weights import build_model
    from test_torch_card_paths import inputs

    steps, b = 24, 8
    cfg = apply_overrides(get_preset("gst_taco2"), {"model.decoder.stop_threshold": 1.0,
                                                    "model.decoder.max_decode_steps": steps})
    model = build_model(cfg, seed=0, device=dev)
    texts, wavs = inputs(steps, cfg.audio.sample_rate, b=b)
    ops.reset_launch_counts()
    out = Synthesizer(cfg, model, device=dev)(texts, reference_wavs=wavs)
    torch.cuda.synchronize()
    counted = {k: n for k, n in ops.launch_counts().items() if n}
    assert counted == {"gru_scan": 1, "refenc_stack": 1, "refenc_stack:bf16": 1,
                       "stft_features": 1, "stft_features:bf16": 1, "decode_scan": 1,
                       "decode_scan:lstm": 1, "griffin_lim": 30}
    for key, shape in {"mel": (b, steps, 80), "mel_postnet": (b, steps, 80),
                       "alignments": (b, steps, 64), "wav": (b, 256 * (steps - 1))}.items():
        assert out[key].shape == shape, key
        assert np.all(np.isfinite(out[key])), key
    assert "linear" not in out
    det, plain = (Synthesizer(cfg, model, device=dev, deterministic_prenet=True, plain=p)(
        texts, reference_wavs=wavs) for p in (False, True))
    for key in ("mel", "mel_postnet"):
        assert float(np.abs(det[key] - plain[key]).max()) <= 2e-3, key
    tok = torch.zeros(2, 8, dtype=torch.int64, device=dev)
    with pytest.raises(NotImplementedError, match="synthesis only"):
        model(tok, None, torch.zeros(2, 4, 80, device=dev))
