"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes that chip_smoke.py's main-path shapes do not reach
(tiny widths, odd lengths, length-0 rows, a frame count off the kernel's
tile), and the STFT extractor's routes. Needs an NVIDIA GPU and nvcc;
skipped without a card. On the GPU machine, which has no JAX
(tests/conftest.py imports it), run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def rand(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


@pytest.mark.parametrize("b,t,d,h", [(3, 7, 5, 4), (2, 33, 256, 128), (1, 1, 3, 45)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_kernel(dev, b, t, d, h, reverse):
    from gst_tacotron_tpu_torch.ops.gru import KERNEL, gru_scan, gru_scan_plain

    g = torch.Generator().manual_seed(b * t + h)
    args = [rand(g, b, t, d), rand(g, b, h, scale=0.5), rand(g, d, 3 * h, scale=0.3),
            rand(g, 3 * h, scale=0.1), rand(g, h, 3 * h, scale=0.3), rand(g, 3 * h, scale=0.1)]
    args = [a.to(dev) for a in args]
    lengths = torch.tensor(([t, 0, max(1, t // 2)] * b)[:b], device=dev)
    before = KERNEL.launches
    got = gru_scan(*args, lengths=lengths, reverse=reverse)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    ref = gru_scan_plain(*args, lengths=lengths, reverse=reverse)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


@pytest.mark.parametrize("t,f,channels", [(19, 16, (4, 4, 8)), (64, 80, (32, 32, 64)),
                                          (5, 7, (3,))])
def test_refenc_stack_kernel(dev, t, f, channels):
    from gst_tacotron_tpu_torch.ops.refenc import refenc_stack, refenc_stack_plain

    g = torch.Generator().manual_seed(t)
    ks, c_in = [], 1
    for c in channels:
        ks.append(rand(g, 3, 3, c_in, c, scale=0.4).to(dev))
        c_in = c
    sc = [(torch.rand(k.shape[-1], generator=g) + 0.5).to(dev) for k in ks]
    bi = [rand(g, k.shape[-1], scale=0.1).to(dev) for k in ks]
    mel = torch.rand(3, t, f, generator=g).to(dev)
    lengths = torch.tensor([t, 1, t // 2 + 1], device=dev)
    got = refenc_stack(mel, ks, sc, bi, lengths=lengths)
    ref = refenc_stack_plain(mel, ks, sc, bi, lengths=lengths)
    # chip_smoke.py's K2 tolerance: float32 sums over up to 9*C_in terms in
    # another order, several layers deep
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("win", [512, 256])
def test_stft_features_kernel(dev, win):
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.ops.stft import stft_features, stft_features_plain

    cfg = AudioConfig(n_fft=512, hop_length=128, win_length=win)
    g = torch.Generator().manual_seed(win)
    frames = 21                           # not a multiple of the kernel's 16-frame tile
    wav = (torch.rand(3, 512 + 128 * (frames - 1), generator=g) - 0.5).to(dev)
    got = stft_features(wav, cfg)
    ref = stft_features_plain(wav, cfg)
    assert got[0].shape == (3, frames, 80) and got[1].shape == (3, frames, 257)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, atol=5e-4, rtol=0)


@pytest.mark.parametrize("win", [512, 256])
@pytest.mark.parametrize("normalize_linear", [True, False])
def test_stft_fused_kernel(dev, win, normalize_linear):
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.ops.stft import (FUSED_KERNEL, stft_features_fused,
                                                 stft_features_plain)

    cfg = AudioConfig(n_fft=512, hop_length=128, win_length=win)
    g = torch.Generator().manual_seed(win + 1)
    frames = 21                           # not a multiple of the kernel's 16-frame tile
    wav = (torch.rand(3, 512 + 128 * (frames - 1) + 77, generator=g) - 0.5).to(dev)
    before = FUSED_KERNEL.launches
    got = stft_features_fused(wav, cfg, normalize_linear=normalize_linear)
    torch.cuda.synchronize()
    assert FUSED_KERNEL.launches == before + 1
    ref = stft_features_plain(wav, cfg, normalize_linear=normalize_linear)
    assert got[0].shape == (3, frames, 80) and got[1].shape == (3, frames, 257)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, atol=5e-4, rtol=1e-5)
    # deterministic: the partial mels are summed in a fixed order
    again = stft_features_fused(wav, cfg, normalize_linear=normalize_linear)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_stft_fused_kernel_bf16(dev):
    """bf16 bases: the kernel rounds frames and bases as the plain version
    does, so the two agree to float32 sums; both stay near float32 features
    on loud bins (tests/test_pallas.py's bf16 budget)."""
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.ops.stft import stft_features_fused, stft_features_plain

    cfg = AudioConfig(n_fft=512, hop_length=128, win_length=512)
    g = torch.Generator().manual_seed(5)
    wav = (torch.rand(2, 512 + 128 * 40, generator=g) - 0.5).to(dev)
    got = stft_features_fused(wav, cfg, bf16_bases=True)
    ref = stft_features_plain(wav, cfg, bf16_bases=True)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, atol=5e-4, rtol=1e-5)
    f32 = stft_features_plain(wav, cfg)[0]
    loud = f32 > 0.5
    assert loud.any() and float((got[0] - f32).abs()[loud].max()) < 0.05


@pytest.mark.parametrize("win", [512, 256])
@pytest.mark.parametrize("n", [37, 1, 16])
def test_stft_frames_kernel(dev, win, n):
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.ops.stft import (FRAMES_KERNEL, stft_features_frames,
                                                 stft_features_frames_plain)

    cfg = AudioConfig(n_fft=512, hop_length=128, win_length=win)
    g = torch.Generator().manual_seed(n + win)
    frames = (torch.rand(n, 512, generator=g) - 0.5).to(dev)
    for normalize_linear in (True, False):
        before = FRAMES_KERNEL.launches
        got = stft_features_frames(frames, cfg, normalize_linear=normalize_linear)
        torch.cuda.synchronize()
        assert FRAMES_KERNEL.launches == before + 1
        ref = stft_features_frames_plain(frames, cfg, normalize_linear=normalize_linear)
        assert got[0].shape == (n, 80) and got[1].shape == (n, 257)
        for x, y in zip(got, ref):
            torch.testing.assert_close(x, y, atol=5e-4, rtol=1e-5)


@pytest.mark.parametrize("route,kernel", [("resident", "stft_features"),
                                          ("fused", "stft_fused"),
                                          ("frames", "stft_frames"),
                                          (None, None)])
def test_extractor_route_launches_its_own_kernel(dev, route, kernel):
    """Each extractor route launches its own kernel once per device batch and
    no other; the plain route (None) launches none."""
    import numpy as np

    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.dsp import ref as dsp_ref
    from gst_tacotron_tpu_torch.dsp.device_features import DeviceFeatureExtractor

    cfg = AudioConfig(n_fft=512, hop_length=128, win_length=256)
    rng = np.random.default_rng(8)
    wavs = [rng.uniform(-0.5, 0.5, n).astype(np.float32) for n in (1000, 2500, 700, 5000, 1001)]
    ex = DeviceFeatureExtractor(cfg, dev, batch_size=2, frame_bucket=8, stft_kernel=route)
    ops.reset_launch_counts()
    res = ex.extract(wavs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    calls = len(ex.plan([1 + len(w) // cfg.hop_length for w in wavs]))
    assert counts == {**dict.fromkeys(counts, 0), **({kernel: calls} if kernel else {})}
    for wav, (mel, lin) in zip(wavs, res):
        np.testing.assert_allclose(mel, dsp_ref.melspectrogram(wav, cfg), atol=5e-4)
        np.testing.assert_allclose(lin, dsp_ref.spectrogram(wav, cfg), atol=5e-4)


@pytest.mark.parametrize("use_dropout", [False, True])
def test_decode_scan_kernel(dev, use_dropout):
    from gst_tacotron_tpu_torch.config import AttentionConfig, DecoderConfig
    from gst_tacotron_tpu_torch.models.decoder import DecoderCell
    from gst_tacotron_tpu_torch.ops.decode import decode_scan, decode_scan_plain
    from gst_tacotron_tpu_torch.weights import init_weights

    dec = DecoderConfig(prenet_dims=(16, 8), attention_rnn_dim=16, decoder_rnn_dim=24,
                        reduction_factor=3, max_decode_steps=7)
    attn = AttentionConfig(dim=12)
    cell = DecoderCell(dec, attn, 10, 20)
    init_weights(cell, seed=3)
    cell = cell.to(dev)
    g = torch.Generator().manual_seed(4)
    memory = rand(g, 3, 9, 20).to(dev)
    with torch.no_grad():
        keys = cell.precompute_keys(memory).contiguous()
    lengths = torch.tensor([9, 0, 4], device=dev)
    kw = dict(dec_cfg=dec, attn_cfg=attn, num_mels=10, steps=7, seed=11,
              use_dropout=use_dropout)
    got = decode_scan(cell.pack(), memory, keys, lengths, **kw)
    ref = decode_scan_plain(cell.pack(), memory, keys, lengths, **kw)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_dropout", [False, True])
@pytest.mark.parametrize("r,cumulative", [(1, True), (2, False)])
def test_decode_scan_lsa_kernel(dev, use_dropout, r, cumulative):
    from gst_tacotron_tpu_torch.config import AttentionConfig, DecoderConfig
    from gst_tacotron_tpu_torch.models.decoder import DecoderCell
    from gst_tacotron_tpu_torch.ops.decode import decode_scan, decode_scan_plain
    from gst_tacotron_tpu_torch.weights import init_weights

    dec = DecoderConfig(prenet_dims=(16, 8), attention_rnn_dim=16, decoder_rnn_dim=24,
                        reduction_factor=r, max_decode_steps=9)
    attn = AttentionConfig(kind="location_sensitive", dim=12, location_filters=5,
                           location_kernel_size=7, cumulative=cumulative)
    cell = DecoderCell(dec, attn, 10, 20)
    init_weights(cell, seed=5)
    cell = cell.to(dev)
    g = torch.Generator().manual_seed(6)
    t = 37                                # not a multiple of 32 (nor of the warp's 2)
    memory = rand(g, 3, t, 20).to(dev)
    with torch.no_grad():
        keys = cell.precompute_keys(memory).contiguous()
    lengths = torch.tensor([t, 0, 20], device=dev)
    kw = dict(dec_cfg=dec, attn_cfg=attn, num_mels=10, steps=9, seed=13,
              use_dropout=use_dropout)
    got = decode_scan(cell.pack(), memory, keys, lengths, **kw)
    ref = decode_scan_plain(cell.pack(), memory, keys, lengths, **kw)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


@pytest.mark.parametrize("b,t,c,h,bits", [(3, 5, 16, 16, 8), (2, 4, 12, 13, 5), (2, 0, 8, 8, 3)])
@pytest.mark.parametrize("greedy", [True, False])
def test_wavernn_sample_kernel(dev, b, t, c, h, bits, greedy):
    """Held teacher-forced: with the plain pass run on the kernel's own
    classes, every class scores within rounding of its step's best (a
    near-tie may flip under another summation order, and the histories part
    after it). Also: the same seed gives the same classes."""
    from gst_tacotron_tpu_torch.config import VocoderConfig
    from gst_tacotron_tpu_torch.models.wavernn import WaveRNN
    from gst_tacotron_tpu_torch.ops.wavernn import KERNEL, score_gaps, wavernn_sample
    from gst_tacotron_tpu_torch.weights import init_weights

    hop = 4
    model = WaveRNN(VocoderConfig(kind="wavernn", wavernn_gru_dim=h, wavernn_fc_dim=c,
                                  wavernn_bits=bits, wavernn_hop=hop), 6)
    init_weights(model, seed=b + c)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape))
    model = model.to(dev)
    g = torch.Generator().manual_seed(t + h)
    mel = torch.rand(b, t, 6, generator=g).to(dev)
    with torch.no_grad():
        cond = model.cond_frames(mel).contiguous()
    packed = model.pack()
    kw = dict(hop=hop, seed=21, temperature=0.9, greedy=greedy)
    before = KERNEL.launches
    classes = wavernn_sample(packed, cond, **kw)
    again = wavernn_sample(packed, cond, **kw)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + (2 if t else 0)
    assert classes.shape == (b, t * hop) and classes.dtype == torch.int32
    assert torch.equal(classes, again)
    if t:
        assert int(classes.min()) >= 0 and int(classes.max()) < 2 ** bits
        gaps = score_gaps(packed, cond, classes, **kw)
        assert float(gaps.max()) <= 1e-4
