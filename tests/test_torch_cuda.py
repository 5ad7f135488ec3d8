"""The port's CUDA kernels against their plain versions on the card: at the
main path's shapes (B=32, 64 tokens, 128 reference frames, the configs'
decode lengths), at small and ragged shapes (tiny widths, odd lengths,
length-0 rows, a frame count off the kernel's tile), and the STFT
extractor's routes. Needs an NVIDIA GPU and nvcc; skipped without a card.
On the GPU machine, which has no JAX (tests/conftest.py imports it), run
this module with the other card modules:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py \
        tests/test_torch_card_paths.py tests/test_torch_card_train.py \
        tests/test_torch_gl_tables.py tests/test_torch_train_graph.py \
        tests/test_torch_card_taco2.py -q
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    """The card, TF32 off, every kernel built (one nvcc a source, all at
    once); the other card modules import this fixture."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU or interpret mode")
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.ops.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all(ops.all_kernels())
    return torch.device("cuda", 0)


def rand(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


# tiny and odd widths (H not divisible by the 8-CTA cluster), and H=128 at the
# main path's scans: the reference-encoder call (T=2, D=256), the post-net's
# 400 steps, and B=33, one row past the clusters' 4-row multiple; H = 129 and
# 256 (16 weights a lane), 300 and 512 (the streamed form)
@pytest.mark.parametrize("b,t,d,h", [(3, 7, 5, 4), (2, 33, 256, 128), (1, 1, 3, 45),
                                     (32, 2, 256, 128), (32, 400, 128, 128),
                                     (33, 64, 128, 128), (3, 9, 5, 129), (32, 40, 128, 256),
                                     (5, 11, 7, 300), (33, 20, 64, 512)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_kernel(dev, b, t, d, h, reverse):
    """Ragged lengths with a length-0 row; two runs give the same bits."""
    from gst_tacotron_tpu_torch.ops.gru import KERNEL, gru_scan, gru_scan_plain

    g = torch.Generator().manual_seed(b * t + h)
    # past H = 128 the recurrent weights shrink as 1/H: at a fixed 0.3 the
    # scan is chaotic there, and float32 rounding alone (the plain version
    # against float64) grows to 2e-2 within 40 steps at H = 256
    wh_scale = 0.3 * min(1.0, 128 / h)
    args = [rand(g, b, t, d), rand(g, b, h, scale=0.5), rand(g, d, 3 * h, scale=0.3),
            rand(g, 3 * h, scale=0.1), rand(g, h, 3 * h, scale=wh_scale),
            rand(g, 3 * h, scale=0.1)]
    args = [a.to(dev) for a in args]
    lengths = torch.tensor(([t, 0, max(1, t // 2)] * b)[:b], device=dev)
    before = KERNEL.launches
    got = gru_scan(*args, lengths=lengths, reverse=reverse)
    again = gru_scan(*args, lengths=lengths, reverse=reverse)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 2
    ref = gru_scan_plain(*args, lengths=lengths, reverse=reverse)
    for x, y, z in zip(got, ref, again):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)
        assert torch.equal(x, z)


# the main path's BiGRUs at B = 32: the encoder's (64 tokens) and the
# post-net's (400 frames); the encoder's shape at H = 256 and 512
@pytest.mark.parametrize("b,t,d,h", [(33, 400, 128, 128), (3, 7, 5, 45), (2, 5, 3, 4),
                                     (32, 64, 128, 128), (32, 400, 128, 128),
                                     (32, 64, 128, 256), (32, 64, 128, 512)])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_bigru_scan_kernel_is_two_scans(dev, b, t, d, h, with_lengths):
    """Both directions in one launch: the bits of a forward and a reverse
    gru_scan, and the plain version's values; the same bits on a second
    run; without lengths every step counts."""
    from gst_tacotron_tpu_torch.ops.gru import KERNEL, bigru_scan, gru_scan, gru_scan_plain

    g = torch.Generator().manual_seed(b * t + h)
    xs = rand(g, b, t, d).to(dev)
    # past H = 128 the recurrent weights shrink as 1/H (test_gru_scan_kernel)
    wh_scale = 0.1 * min(1.0, 128 / h)
    fwd, bwd = ([a.to(dev) for a in (rand(g, b, h, scale=0.5), rand(g, d, 3 * h, scale=0.1),
                                    rand(g, 3 * h, scale=0.1), rand(g, h, 3 * h, scale=wh_scale),
                                    rand(g, 3 * h, scale=0.1))] for _ in range(2))
    lengths = torch.tensor(([t, 0, max(1, t // 2)] * b)[:b], device=dev) if with_lengths \
        else None
    before = KERNEL.launches
    ys, (f_final, b_final) = bigru_scan(xs, fwd, bwd, lengths=lengths)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1 and ys.shape == (b, t, 2 * h)
    f = gru_scan(xs, *fwd, lengths=lengths)
    r = gru_scan(xs, *bwd, lengths=lengths, reverse=True)
    assert torch.equal(ys, torch.cat([f[0], r[0]], -1))
    assert torch.equal(f_final, f[1]) and torch.equal(b_final, r[1])
    again, (f_again, b_again) = bigru_scan(xs, fwd, bwd, lengths=lengths)
    assert torch.equal(ys, again) and torch.equal(f_final, f_again)
    assert torch.equal(b_final, b_again)
    pf = gru_scan_plain(xs, *fwd, lengths=lengths)
    pr = gru_scan_plain(xs, *bwd, lengths=lengths, reverse=True)
    for x, y in zip((ys, f_final, b_final), (torch.cat([pf[0], pr[0]], -1), pf[1], pr[1])):
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
    # K2's tolerance: float32 sums over up to 9*C_in terms in another order,
    # several layers deep
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


# the reference encoder's six layers, as the main path runs them on a
# (32, 128, 80) reference mel
REFENC_CHANNELS = (32, 32, 64, 64, 128, 128)


def device_launches(fn, name):
    """Device-side launches of the kernels whose name holds ``name`` in one
    call of ``fn``, from torch.profiler (profiled once more where it saw
    none: it has lost every event of a call before)."""
    from torch.profiler import ProfilerActivity, profile

    n = 0
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages() if name in e.key)
        if n:
            break
    return n


@pytest.mark.parametrize("bf16", [False, True])
def test_refenc_stack_kernel_at_the_main_shape(dev, bf16):
    """K2 on the main path's (32, 128, 80) stack, Glorot-scaled kernels,
    ragged, full and no lengths, the same bits twice. float32: within 1e-4
    of the plain version, also at T = 101 (off the 64-frame multiple), and
    layers 0-2 launch at least one block an SM. The bf16 mode: the plain
    version's bf16 rounding within 0.05 and far closer on average than to
    float32, rows 16-31 alone give the 32-row launch's bits, and a stack
    launches its plan's kernels, at most 2."""
    from gst_tacotron_tpu_torch.ops.refenc import (bf16_plan, layer_plan, refenc_stack,
                                                   refenc_stack_plain)

    b, t, f = 32, 128, 80
    g = torch.Generator().manual_seed(t + bf16)
    ks, c_in = [], 1
    for c in REFENC_CHANNELS:
        lim = (6 / (9 * c_in + 9 * c)) ** 0.5
        ks.append(((torch.rand(3, 3, c_in, c, generator=g) * 2 - 1) * lim).to(dev))
        c_in = c
    sc = [(torch.rand(k.shape[-1], generator=g) + 0.5).to(dev) for k in ks]
    bi = [rand(g, k.shape[-1], scale=0.1).to(dev) for k in ks]
    mel = torch.rand(b, t, f, generator=g).to(dev)
    ragged = torch.randint(1, t + 1, (b,), generator=g).to(dev)
    for lengths in (ragged, torch.full((b,), t, device=dev), None):
        got = refenc_stack(mel, ks, sc, bi, lengths=lengths, bf16=bf16)
        assert torch.equal(got, refenc_stack(mel, ks, sc, bi, lengths=lengths, bf16=bf16))
        ref = refenc_stack_plain(mel, ks, sc, bi, lengths=lengths, bf16=bf16)
        if not bf16:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
            continue
        f32 = refenc_stack_plain(mel, ks, sc, bi, lengths=lengths)
        assert float((got - ref).abs().max()) < 0.05
        assert float((got - ref).abs().mean()) < float((got - f32).abs().mean()) / 5
        rows = None if lengths is None else lengths[b // 2:]
        half = refenc_stack(mel[b // 2:].contiguous(), ks, sc, bi, lengths=rows, bf16=True)
        assert torch.equal(half, got[b // 2:])
    if bf16:
        launches = len(bf16_plan(t, f, REFENC_CHANNELS)["launches"])
        assert launches <= 2
        assert device_launches(lambda: refenc_stack(mel, ks, sc, bi, bf16=True),
                               "refenc_bf16_kernel") == launches
        return
    odd = mel[:, :101]
    torch.testing.assert_close(refenc_stack(odd, ks, sc, bi), refenc_stack_plain(odd, ks, sc, bi),
                               atol=1e-4, rtol=0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert min(p["blocks"] for p in layer_plan(b, t, f, REFENC_CHANNELS, sms)[:3]) >= sms


@pytest.mark.parametrize("n_fft,hop,win,b,frames,normalize_linear", [
    (512, 128, 512, 3, 21, True),        # 21 frames: not a multiple of the 4-frame block
    (512, 128, 256, 3, 21, True),
    (2048, 256, 1024, 3, 21, True),      # the configs' STFT
    (2048, 256, 1024, 2, 128, True),     # the main path's 128 frames
    (2048, 256, 1024, 8, 128, True),     # a main-path launch: 8 wavs of 128 frames
    (2048, 256, 1024, 3, 21, False),     # the raw magnitude
    (2048, 256, 1024, 1, 128, True),     # one wav
    (1024, 256, 1024, 2, 37, True),      # log2(n_fft / 2) odd: the radix-2 stage
])
def test_stft_features_kernel(dev, n_fft, hop, win, b, frames, normalize_linear):
    """K3's FFT: one launch a call, the plain version's features, and the
    same bits on a second run."""
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.ops.stft import KERNEL, stft_features, stft_features_plain

    cfg = AudioConfig(n_fft=n_fft, hop_length=hop, win_length=win)
    g = torch.Generator().manual_seed(win if n_fft == 512 else n_fft + frames + b)
    wav = (torch.rand(b, n_fft + hop * (frames - 1), generator=g) - 0.5).to(dev)
    before = KERNEL.launches
    got = stft_features(wav, cfg, normalize_linear=normalize_linear)
    again = stft_features(wav, cfg, normalize_linear=normalize_linear)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 2
    ref = stft_features_plain(wav, cfg, normalize_linear=normalize_linear)
    assert got[0].shape == (b, frames, 80) and got[1].shape == (b, frames, n_fft // 2 + 1)
    for x, y, z in zip(got, ref, again):
        # raw magnitudes reach the hundreds: relative to their size
        torch.testing.assert_close(x, y, atol=5e-4, rtol=0 if normalize_linear else 1e-5)
        assert torch.equal(x, z)


@pytest.mark.parametrize("n_fft,hop,win", [(1200, 300, 1200), (1536, 256, 1024)])
def test_stft_features_kernel_any_n_fft(dev, n_fft, hop, win):
    """K3 off the powers of two (it once refused them): one launch a call,
    within 5e-4 of the host float64 oracle (tests/test_device_features.py's
    budget) and of the plain version, the same bits twice."""
    import numpy as np

    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.dsp import ref as dsp_ref
    from gst_tacotron_tpu_torch.ops.stft import KERNEL, stft_features, stft_features_plain

    cfg = AudioConfig(n_fft=n_fft, hop_length=hop, win_length=win)
    g = torch.Generator().manual_seed(n_fft)
    raw = ((torch.rand(2, hop * 40, generator=g) - 0.5) * 0.6).numpy().astype(np.float64)
    pre = [np.pad(dsp_ref.preemphasis(w, cfg.preemphasis), n_fft // 2, mode="reflect")
           for w in raw]
    wav = torch.from_numpy(np.stack(pre).astype(np.float32)).to(dev)
    before = KERNEL.launches
    got, again = stft_features(wav, cfg), stft_features(wav, cfg)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 2
    for i, w in enumerate(raw):
        oracle = (dsp_ref.melspectrogram(w, cfg), dsp_ref.spectrogram(w, cfg))
        for x, y in zip(got, oracle):
            assert float(np.abs(x[i].cpu().numpy() - y).max()) <= 5e-4
    for x, y, z in zip(got, stft_features_plain(wav, cfg), again):
        torch.testing.assert_close(x, y, atol=5e-4, rtol=0)
        assert torch.equal(x, z)


@pytest.mark.parametrize("win", [512, 256])
@pytest.mark.parametrize("normalize_linear", [True, False])
def test_stft_fused_kernel(dev, win, normalize_linear):
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.ops.stft import (FUSED_KERNEL, stft_features_fused,
                                                 stft_features_plain)

    cfg = AudioConfig(n_fft=512, hop_length=128, win_length=win)
    g = torch.Generator().manual_seed(win + 1)
    frames = 21                           # not a multiple of the kernel's frames a block
    wav = (torch.rand(3, 512 + 128 * (frames - 1) + 77, generator=g) - 0.5).to(dev)
    before = FUSED_KERNEL.launches
    got = stft_features_fused(wav, cfg, normalize_linear=normalize_linear)
    torch.cuda.synchronize()
    assert FUSED_KERNEL.launches == before + 1
    ref = stft_features_plain(wav, cfg, normalize_linear=normalize_linear)
    assert got[0].shape == (3, frames, 80) and got[1].shape == (3, frames, 257)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, atol=5e-4, rtol=1e-5)
    # deterministic: one launch, each mel filter summed in ascending bin order
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


# n_fft 1200 (600 = 4·2·3·5·5) and 1536 (768 = 4⁴·3) run the mixed-radix
# stages, 1026 (513 = 3³·19) the generic one, odd 1575 (3²·5²·7) the
# unpacked real transform; 512 and 2048 radix 4 and 2 only; 3 wavs of 37
# frames (not a multiple of any frames a block), and a main-path launch:
# 8 wavs of 128 frames at n_fft 2048
MIXED_STFT = [(512, 128, 512, 3, 37), (1200, 300, 1200, 3, 37), (1536, 256, 1024, 3, 37),
              (2048, 256, 1024, 3, 37), (1026, 342, 1000, 3, 37), (1575, 525, 1500, 3, 37),
              (2048, 256, 1024, 8, 128)]


@pytest.mark.parametrize("n_fft,hop,win,b,t", MIXED_STFT)
@pytest.mark.parametrize("form", ["frames", "fused", "fused_bf16"])
def test_stft_mixed_radix_kernels(dev, n_fft, hop, win, b, t, form):
    """K3″ and K3′ (both modes) at any n_fft: one launch a call, the plain
    version's features (bf16: the plain version's bf16 rounding, and near
    float32 on loud bins), the same bits on a second run."""
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP
    from gst_tacotron_tpu_torch.ops import stft

    cfg = AudioConfig(n_fft=n_fft, hop_length=hop, win_length=win)
    g = torch.Generator().manual_seed(n_fft + len(form) + t)
    wav = (torch.rand(b, n_fft + hop * (t - 1) + 77, generator=g) - 0.5).to(dev)
    bf16 = form == "fused_bf16"
    if form == "frames":
        x = TorchDSP(cfg, dev).frame_precentered(wav).reshape(-1, n_fft).contiguous()
        kernel, run = stft.FRAMES_KERNEL, lambda: stft.stft_features_frames(x, cfg)
        ref = stft.stft_features_frames_plain(x, cfg)
    else:
        kernel = stft.FUSED_KERNEL
        run = lambda: stft.stft_features_fused(wav, cfg, bf16_bases=bf16)
        ref = stft.stft_features_plain(wav, cfg, bf16_bases=bf16)
    before = kernel.launches
    got, again = run(), run()
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert got[1].shape[-1] == n_fft // 2 + 1 and got[0].shape[-1] == 80
    for x, y, z in zip(got, ref, again):
        torch.testing.assert_close(x, y, atol=5e-4, rtol=1e-5)
        assert torch.equal(x, z)
    if bf16:
        f32 = stft.stft_features_plain(wav, cfg)[0]
        loud = f32 > 0.5
        assert loud.any() and float((got[0] - f32).abs()[loud].max()) < 0.05


def test_stft_fft_kernels_give_k3s_features(dev):
    """n_fft 2048: K3′ (float32) on the wav and K3″ on its frames run K3's
    arithmetic, so they agree with K3 to 1e-6 (the same bits unless the
    compiler contracted a product differently)."""
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP
    from gst_tacotron_tpu_torch.ops import stft

    cfg = AudioConfig(n_fft=2048, hop_length=256, win_length=1024)
    g = torch.Generator().manual_seed(2048)
    wav = ((torch.rand(4, 2048 + 256 * 127, generator=g) - 0.5) * 0.6).to(dev)
    k3 = stft.stft_features(wav, cfg)
    fused = stft.stft_features_fused(wav, cfg)
    x = TorchDSP(cfg, dev).frame_precentered(wav).reshape(-1, 2048).contiguous()
    frames = [y.reshape(k.shape) for y, k in zip(stft.stft_features_frames(x, cfg), k3)]
    for got in (fused, frames):
        for a, b in zip(got, k3):
            assert float((a - b).abs().max()) <= 1e-6


@pytest.mark.parametrize("n_fft,hop,route", [
    (29058, 14529, "frames"), (32768, 4096, "fused"), (32768, 4096, "resident"),
    (15625, 3125, "frames"), (15625, 3125, "fused"),   # odd, 5^6: past one block's 14527
    (6144, 1536, "fused_bf16"), (8192, 2048, "fused_bf16")])  # bf16: past 8 bin windows
def test_stft_fft_kernels_past_shared_memory(dev, n_fft, hop, route):
    """Sizes the kernels once refused: past one frame's shared memory the
    FFT runs on a device-memory scratch (float32), and bf16 bases walk
    several bin windows a CTA with the magnitudes on a device-memory
    scratch (one launch a call); each agrees with the plain features."""
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP
    from gst_tacotron_tpu_torch.ops import stft

    cfg = AudioConfig(n_fft=n_fft, hop_length=hop, win_length=n_fft - hop)
    g = torch.Generator().manual_seed(n_fft + len(route))
    wav = ((torch.rand(2, n_fft + hop * 6 + 5, generator=g) - 0.5) * 0.6).to(dev)
    dsp = TorchDSP(cfg, dev)
    if route == "frames":
        x = dsp.frame_precentered(wav).reshape(-1, n_fft).contiguous()
        got = [y.reshape(2, -1, y.shape[-1]) for y in stft.stft_features_frames(x, cfg)]
    elif route == "fused_bf16":
        assert stft.bf16_plan(n_fft, hop, stft.live_tap_span(cfg)[2], cfg.num_mels)["scratch"] == 1
        before = stft.FUSED_KERNEL.launches
        got = stft.stft_features_fused(wav, cfg, bf16_bases=True)
        assert stft.FUSED_KERNEL.launches == before + 1
    else:
        run = stft.stft_features if route == "resident" else stft.stft_features_fused
        got = run(wav, cfg)
    # torch.fft's features (the dense plain version would build n_live x
    # n_fft/2 bases), and the plain version's own bf16 rounding for bf16
    ref = stft.stft_features_plain(wav, cfg, bf16_bases=True) if route == "fused_bf16" \
        else dsp.features_precentered(wav)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, atol=5e-4, rtol=1e-5)


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
    no other; the plain route (None) launches none. float32 by name: the
    features are held against the float64 oracle (the resident route's
    card default, K3's bf16 mode, has its own test below)."""
    import numpy as np

    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.dsp import ref as dsp_ref
    from gst_tacotron_tpu_torch.dsp.device_features import DeviceFeatureExtractor

    cfg = AudioConfig(n_fft=512, hop_length=128, win_length=256)
    rng = np.random.default_rng(8)
    wavs = [rng.uniform(-0.5, 0.5, n).astype(np.float32) for n in (1000, 2500, 700, 5000, 1001)]
    ex = DeviceFeatureExtractor(cfg, dev, batch_size=2, frame_bucket=8, stft_kernel=route,
                                bf16=False)
    ops.reset_launch_counts()
    res = ex.extract(wavs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    calls = len(ex.plan([1 + len(w) // cfg.hop_length for w in wavs]))
    assert counts == {**dict.fromkeys(counts, 0), **({kernel: calls} if kernel else {})}
    for wav, (mel, lin) in zip(wavs, res):
        np.testing.assert_allclose(mel, dsp_ref.melspectrogram(wav, cfg), atol=5e-4)
        np.testing.assert_allclose(lin, dsp_ref.spectrogram(wav, cfg), atol=5e-4)


# the JAX on-chip test's reference-encoder lengths at its (8, 256, 80) shape
# (tpu_tests/test_kernels_on_chip.py, test_refenc_batched_bf16_compiled)
ONCHIP_LENGTHS = [256, 250, 64, 199, 31, 128, 256, 7]


def test_refenc_stack_kernel_bf16(dev):
    """K2's bf16 operand mode at the flagship (8, 256, 80) stack with JAX's
    on-chip lengths: the plain version's bf16 rounding (the same operands,
    float32 sums; a value on a rounding boundary moves one bf16 step), far
    closer on average than to float32; the embedding within JAX's 0.05 of
    float32; counted on its branch; the same bits twice; and a row's bits
    whatever the batch (no k split)."""
    from gst_tacotron_tpu_torch.config import GSTConfig
    from gst_tacotron_tpu_torch.models.gst import ReferenceEncoder
    from gst_tacotron_tpu_torch.ops.refenc import (KERNEL, ref_encoder, refenc_stack,
                                                   refenc_stack_plain)
    from gst_tacotron_tpu_torch.weights import init_weights

    g = torch.Generator().manual_seed(0)
    mel = torch.randn(8, 256, 80, generator=g).to(dev)
    lengths = torch.tensor(ONCHIP_LENGTHS, device=dev)
    enc = ReferenceEncoder(GSTConfig(), 80)
    init_weights(enc, seed=0)
    enc = enc.to(dev).eval()
    ks = [getattr(enc, f"conv_{i}").kernel.detach() for i in range(6)]
    sc = [(torch.rand(k.shape[-1], generator=g) + 0.5).to(dev) for k in ks]
    bi = [rand(g, k.shape[-1], scale=0.1).to(dev) for k in ks]
    before, branch = KERNEL.launches, KERNEL.branch_launches["bf16"]
    got = refenc_stack(mel, ks, sc, bi, lengths=lengths, bf16=True)
    again = refenc_stack(mel, ks, sc, bi, lengths=lengths, bf16=True)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 2 and KERNEL.branch_launches["bf16"] == branch + 2
    assert torch.equal(got, again)
    ref = refenc_stack_plain(mel, ks, sc, bi, lengths=lengths, bf16=True)
    f32 = refenc_stack_plain(mel, ks, sc, bi, lengths=lengths)
    assert float((got - ref).abs().max()) < 0.05
    assert float((got - ref).abs().mean()) < float((got - f32).abs().mean()) / 5
    half = refenc_stack(mel[4:].contiguous(), ks, sc, bi, lengths=lengths[4:], bf16=True)
    assert torch.equal(half, got[4:])
    with torch.no_grad():
        emb = ref_encoder(enc, mel, lengths)                  # None: bf16 on the card
        emb32 = ref_encoder(enc, mel, lengths, bf16=False)
        emb_plain = ref_encoder(enc, mel, lengths, plain=True)
    assert float((emb - emb32).abs().max()) < 0.05
    cos = (emb * emb32).sum(-1) / (emb.norm(dim=-1) * emb32.norm(dim=-1)).clamp(min=1e-9)
    assert float(cos.min()) > 0.995
    torch.testing.assert_close(emb, emb_plain, atol=1e-3, rtol=0)


def test_refenc_stack_kernel_bf16_leading_layers_alone(dev):
    """K2's bf16 mode at a T the one-launch form cannot hold, (2, 4096, 80):
    the plan runs layers 0, 1 and 2 one launch each over bands of rows
    (bf16 activations in device memory), then layers 3-5 on clusters; one
    branch count a stack, the plain version's bf16 rounding, the same bits
    twice, and row 1 alone gives the 2-row launch's bits."""
    from gst_tacotron_tpu_torch.ops.refenc import (KERNEL, bf16_plan, refenc_stack,
                                                   refenc_stack_plain)

    channels = [32, 32, 64, 64, 128, 128]
    plan = bf16_plan(4096, 80, channels)
    assert [(q["l0"], q["l1"]) for q in plan["launches"]] == [(0, 1), (1, 2), (2, 3), (3, 6)]
    g = torch.Generator().manual_seed(4096)
    ks, c_in = [], 1
    for c in channels:
        ks.append(rand(g, 3, 3, c_in, c, scale=1.0 / (3 * c_in ** 0.5)).to(dev))
        c_in = c
    sc = [(torch.rand(k.shape[-1], generator=g) + 0.5).to(dev) for k in ks]
    bi = [rand(g, k.shape[-1], scale=0.1).to(dev) for k in ks]
    mel = torch.rand(2, 4096, 80, generator=g).to(dev)
    lengths = torch.tensor([4096, 2999], device=dev)
    before, branch = KERNEL.launches, KERNEL.branch_launches["bf16"]
    got = refenc_stack(mel, ks, sc, bi, lengths=lengths, bf16=True)
    again = refenc_stack(mel, ks, sc, bi, lengths=lengths, bf16=True)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 2 and KERNEL.branch_launches["bf16"] == branch + 2
    assert torch.equal(got, again)
    ref = refenc_stack_plain(mel, ks, sc, bi, lengths=lengths, bf16=True)
    f32 = refenc_stack_plain(mel, ks, sc, bi, lengths=lengths)
    assert float((got - ref).abs().max()) < 0.05
    assert float((got - ref).abs().mean()) < float((got - f32).abs().mean()) / 5
    one = refenc_stack(mel[1:].contiguous(), ks, sc, bi, lengths=lengths[1:], bf16=True)
    assert torch.equal(one, got[1:])


@pytest.mark.parametrize("n_fft,hop,win,frames", [(2048, 256, 1024, 128), (512, 128, 512, 21),
                                                  (6144, 1536, 4608, 30)])
def test_stft_features_kernel_bf16(dev, n_fft, hop, win, frames):
    """K3's bf16 operand mode: counted on its branch, the plain version's
    bf16 rounding of frames, bases, magnitudes and mel basis (float32 sums),
    far closer on average than to float32 and within tests/test_pallas.py's
    0.05 of it on loud mel bins; the same bits twice; apart from K3′'s bf16
    bases (whose mel product stays float32)."""
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.ops.stft import (KERNEL, stft_features, stft_features_fused,
                                                 stft_features_plain)

    cfg = AudioConfig(n_fft=n_fft, hop_length=hop, win_length=win)
    g = torch.Generator().manual_seed(n_fft + frames)
    wav = ((torch.rand(8, n_fft + hop * (frames - 1), generator=g) - 0.5) * 0.6).to(dev)
    before, branch = KERNEL.launches, KERNEL.branch_launches["bf16"]
    got = stft_features(wav, cfg, bf16=True)
    again = stft_features(wav, cfg, bf16=True)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 2 and KERNEL.branch_launches["bf16"] == branch + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    ref = stft_features_plain(wav, cfg, bf16=True)
    f32 = stft_features_plain(wav, cfg)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, atol=5e-3, rtol=1e-5)
    assert float((got[0] - ref[0]).abs().mean()) < float((got[0] - f32[0]).abs().mean()) / 5
    loud = f32[0] > 0.5
    assert loud.any() and float((got[0] - f32[0]).abs()[loud].max()) < 0.05
    bases = stft_features_fused(wav, cfg, bf16_bases=True)[0]
    assert float((bases - ref[0]).abs().mean()) > float((got[0] - ref[0]).abs().mean())


@pytest.mark.parametrize("num_mels", [8, 200])
def test_stft_features_kernel_bf16_mel_widths(dev, num_mels):
    """K3's bf16 mode where the mel is unusual: 8 mels at n_fft 2048 (each
    filter spans up to 8 of the 144-bin windows, whose partial sums the
    owning CTAs add in order) and 200 mels (past 128: each filter summed
    whole through the scratch); both modes against their plain versions."""
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.ops.stft import (bf16_plan, live_tap_span, stft_features,
                                                 stft_features_fused, stft_features_plain)

    cfg = AudioConfig(n_fft=2048, hop_length=256, win_length=1024, num_mels=num_mels)
    plan = bf16_plan(2048, 256, live_tap_span(cfg)[2], num_mels)
    assert (plan["mel_nt"] == 0) == (num_mels > 128)
    g = torch.Generator().manual_seed(num_mels)
    wav = ((torch.rand(3, 2048 + 256 * 70, generator=g) - 0.5) * 0.6).to(dev)
    for got, ref in ((stft_features(wav, cfg, bf16=True), stft_features_plain(wav, cfg, bf16=True)),
                     (stft_features_fused(wav, cfg, bf16_bases=True),
                      stft_features_plain(wav, cfg, bf16_bases=True))):
        for x, y in zip(got, ref):
            torch.testing.assert_close(x, y, atol=5e-3, rtol=1e-5)


def test_extractor_resident_route_runs_k3_bf16_on_the_card(dev):
    """The resident route's default on the card is K3's bf16 mode (JAX's
    ``bf16=not self.interpret``): one bf16-branch launch a device batch, the
    plain route's bf16 rounding of the same batches."""
    import numpy as np

    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import AudioConfig
    from gst_tacotron_tpu_torch.dsp.device_features import DeviceFeatureExtractor

    cfg = AudioConfig(n_fft=512, hop_length=128, win_length=256)
    rng = np.random.default_rng(8)
    wavs = [rng.uniform(-0.5, 0.5, n).astype(np.float32) for n in (1000, 2500, 700, 5000, 1001)]
    ex = DeviceFeatureExtractor(cfg, dev, batch_size=2, frame_bucket=8)
    assert ex.bf16
    ops.reset_launch_counts()
    res = ex.extract(wavs)
    torch.cuda.synchronize()
    calls = len(ex.plan([1 + len(w) // cfg.hop_length for w in wavs]))
    counts = ops.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), "stft_features": calls,
                      "stft_features:bf16": calls}
    plain = DeviceFeatureExtractor(cfg, dev, batch_size=2, frame_bucket=8, plain=True).extract(wavs)
    for (mel, lin), (pm, pl) in zip(res, plain):
        np.testing.assert_allclose(mel, pm, atol=5e-3)
        np.testing.assert_allclose(lin, pl, atol=5e-3)


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


# K4's phase launches at the configs' widths: B = 32 (one row group), B = 1,
# B = 33 (across a row-group boundary), T = 1; lengths 0 and 1; dropout on;
# gst_multispeaker's memory of 576 (512 + its 64-wide speaker embedding)
@pytest.mark.parametrize("config,b,t", [("gst_lj", 32, 64), ("gst_r1_location", 32, 64),
                                        ("gst_lj", 1, 64), ("gst_r1_location", 33, 64),
                                        ("gst_lj", 33, 1), ("gst_r1_location", 5, 1),
                                        ("gst_multispeaker", 32, 64)])
def test_decode_scan_phases_at_config_widths(dev, config, b, t):
    """Within 1e-5 of the plain version; the same bits on a second run; one
    K4 launch a decode, counted on the branch of the config's attention."""
    import numpy as np

    from gst_tacotron_tpu_torch.config import load_config
    from gst_tacotron_tpu_torch.models.decoder import DecoderCell
    from gst_tacotron_tpu_torch.ops.decode import KERNEL, decode_scan, decode_scan_plain
    from gst_tacotron_tpu_torch.weights import init_weights

    m = load_config(f"configs/{config}.json").model
    # gst_multispeaker: the speaker embedding widens the memory to 576
    mem_dim = (m.encoder.output_dim + m.gst.style_dim
               + (m.speaker_dim if m.num_speakers > 1 else 0))
    cell = DecoderCell(m.decoder, m.attention, m.num_mels, mem_dim)
    init_weights(cell, seed=b + t)
    cell = cell.to(dev)
    rng = np.random.default_rng(b * t)
    memory = torch.from_numpy(rng.normal(0, 0.5, (b, t, mem_dim)).astype(np.float32)).to(dev)
    with torch.no_grad():
        keys = cell.precompute_keys(memory).contiguous()
    lengths = torch.tensor(([t, 0, 1] + list(rng.integers(1, t + 1, b)))[:b], device=dev)
    kw = dict(dec_cfg=m.decoder, attn_cfg=m.attention, num_mels=m.num_mels, steps=4, seed=5,
              use_dropout=True)
    lsa = m.attention.kind == "location_sensitive"
    before, branch = KERNEL.launches, KERNEL.branch_launches["location_sensitive"]
    got = decode_scan(cell.pack(), memory, keys, lengths, **kw)
    again = decode_scan(cell.pack(), memory, keys, lengths, **kw)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 2
    assert KERNEL.branch_launches["location_sensitive"] == branch + (2 if lsa else 0)
    ref = decode_scan_plain(cell.pack(), memory, keys, lengths, **kw)
    for x, y, z in zip(got, ref, again):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)
        assert torch.equal(x, z)


# the main path's decodes: 32 utterances of up to 64 tokens (one of each
# end's length), gst_lj's 200 steps at r=2 and gst_r1_location's 1000 at
# r=1. 1e-3: float32 sums in another order fed back through every step (the
# last frame re-enters the prenet, and the alignment LSA's location taps)
@pytest.mark.parametrize("config,steps", [("gst_lj", 200), ("gst_r1_location", 1000)])
def test_decode_scan_at_the_main_paths_length(dev, config, steps):
    """One launch a decode on the config's branch; within 1e-3 of the plain
    version with dropout off and on (one Philox stream); with dropout every
    value finite, the same seed the same bits, another seed another mel;
    rows 16-31 alone at ``row0`` 16 within 1e-3 of the plain version there
    and of those rows of the 32-row launch."""
    import numpy as np

    from gst_tacotron_tpu_torch.config import load_config
    from gst_tacotron_tpu_torch.models.decoder import DecoderCell
    from gst_tacotron_tpu_torch.ops.decode import KERNEL, decode_scan, decode_scan_plain
    from gst_tacotron_tpu_torch.weights import init_weights

    m = load_config(f"configs/{config}.json").model
    b, t = 32, 64
    mem_dim = m.encoder.output_dim + m.gst.style_dim
    cell = DecoderCell(m.decoder, m.attention, m.num_mels, mem_dim)
    init_weights(cell, seed=7)
    cell = cell.to(dev)
    packed = cell.pack()
    rng = np.random.default_rng(steps)
    memory = torch.from_numpy(rng.normal(0, 0.5, (b, t, mem_dim)).astype(np.float32)).to(dev)
    with torch.no_grad():
        keys = cell.precompute_keys(memory).contiguous()
    lens = rng.integers(t // 2, t + 1, b)
    lens[0], lens[1] = t, 1
    lengths = torch.from_numpy(lens).to(dev)
    kw = dict(dec_cfg=m.decoder, attn_cfg=m.attention, num_mels=m.num_mels, steps=steps)

    def close(got, ref):
        for x, y in zip(got, ref):
            torch.testing.assert_close(x, y, atol=1e-3, rtol=0)

    lsa = m.attention.kind == "location_sensitive"
    before, branch = KERNEL.launches, KERNEL.branch_launches["location_sensitive"]
    got = decode_scan(packed, memory, keys, lengths, **kw)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert KERNEL.branch_launches["location_sensitive"] == branch + lsa
    close(got, decode_scan_plain(packed, memory, keys, lengths, **kw))
    drop = dict(kw, use_dropout=True)
    d1 = decode_scan(packed, memory, keys, lengths, seed=1, **drop)
    d2 = decode_scan(packed, memory, keys, lengths, seed=2, **drop)
    assert all(bool(torch.isfinite(x).all()) for x in d1 + d2)
    assert all(torch.equal(x, y) for x, y in zip(d1, decode_scan(packed, memory, keys, lengths,
                                                                 seed=1, **drop)))
    assert not torch.equal(d1[0], d2[0])
    close(d1, decode_scan_plain(packed, memory, keys, lengths, seed=1, **drop))
    half = b // 2
    shard = (memory[half:].contiguous(), keys[half:].contiguous(), lengths[half:])
    rows = decode_scan(packed, *shard, seed=1, row0=half, **drop)
    close(rows, decode_scan_plain(packed, *shard, seed=1, row0=half, **drop))
    close(rows, [x[half:] for x in d1])


# widths off every multiple of 4 (each product input padded), two row groups
@pytest.mark.parametrize("kind,r", [("bahdanau", 2), ("location_sensitive", 3)])
@pytest.mark.parametrize("use_dropout", [False, True])
def test_decode_scan_phases_at_ragged_widths(dev, kind, r, use_dropout):
    from gst_tacotron_tpu_torch.config import AttentionConfig, DecoderConfig
    from gst_tacotron_tpu_torch.models.decoder import DecoderCell
    from gst_tacotron_tpu_torch.ops.decode import decode_scan, decode_scan_plain
    from gst_tacotron_tpu_torch.weights import init_weights

    dec = DecoderConfig(prenet_dims=(15, 9), attention_rnn_dim=13, decoder_rnn_dim=22,
                        reduction_factor=r, max_decode_steps=8)
    attn = (AttentionConfig(kind=kind, dim=11, location_filters=5, location_kernel_size=7)
            if kind == "location_sensitive" else AttentionConfig(dim=11))
    cell = DecoderCell(dec, attn, 7, 19)
    init_weights(cell, seed=9)
    cell = cell.to(dev)
    g = torch.Generator().manual_seed(10)
    t = 37
    memory = rand(g, 35, t, 19).to(dev)
    with torch.no_grad():
        keys = cell.precompute_keys(memory).contiguous()
    lengths = torch.tensor(([t, 0, 1, 20, 5] * 7)[:35], device=dev)
    kw = dict(dec_cfg=dec, attn_cfg=attn, num_mels=7, steps=8, seed=17,
              use_dropout=use_dropout)
    got = decode_scan(cell.pack(), memory, keys, lengths, **kw)
    ref = decode_scan_plain(cell.pack(), memory, keys, lengths, **kw)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


# K4 resumed from a carried workspace: chunks of 1, 7 and 64 steps over 150
# steps (7 and 64 do not divide them), B = 1, 32 and 33 (two row groups)
@pytest.mark.parametrize("config,b", [("gst_lj", 32), ("gst_lj", 1), ("gst_r1_location", 33)])
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_decode_scan_resumes_in_chunks(dev, config, b, chunk):
    """One launcher call a chunk, each resuming where the one before left the
    workspace, gives the bits of one call over the same steps, dropout on;
    the chunked decode with early exit as well, at stop threshold 1.0 (one
    launch a chunk, on the config's branch), and one chunk at 0.0."""
    import math

    import numpy as np

    from gst_tacotron_tpu_torch.config import apply_overrides, load_config
    from gst_tacotron_tpu_torch.decode import chunked_decode
    from gst_tacotron_tpu_torch.ops.decode import KERNEL, decode_carry, decode_scan
    from gst_tacotron_tpu_torch.weights import build_model

    cfg = apply_overrides(load_config(f"configs/{config}.json"),
                          {"model.decoder.stop_threshold": 1.0})
    model = build_model(cfg, seed=b, device=dev)
    dec = model.decoder
    steps, t = 150, 64
    rng = np.random.default_rng(b + chunk)
    memory = torch.from_numpy(rng.normal(0, 0.5, (b, t, model.memory_dim)).astype(
        np.float32)).to(dev)
    lengths = torch.tensor(([t, 0, 1] + list(rng.integers(1, t + 1, b)))[:b], device=dev)
    with torch.no_grad():
        keys = dec.cell.precompute_keys(memory).contiguous()
        packed = dec.cell.pack()
        kw = dict(dec_cfg=dec.cfg, attn_cfg=dec.attn_cfg, num_mels=dec.num_mels, seed=9,
                  use_dropout=True)
        one = decode_scan(packed, memory, keys, lengths, steps=steps, **kw)
        carry = decode_carry(memory, dec_cfg=dec.cfg, num_mels=dec.num_mels,
                             total_steps=steps)
        before = KERNEL.launches
        s = 0
        while s < steps:
            n = min(chunk, steps - s)
            decode_scan(packed, memory, keys, lengths, steps=n, carry=carry, **kw)
            s += n
        torch.cuda.synchronize()
        assert KERNEL.launches == before + math.ceil(steps / chunk)
        for x, y in zip((carry.mel, carry.stop_logits, carry.aligns), one):
            assert torch.equal(x, y)
        before, branch = KERNEL.launches, KERNEL.branch_launches["location_sensitive"]
        out = chunked_decode(model, memory, lengths, chunk_steps=chunk, max_steps=steps,
                             seed=9)
        torch.cuda.synchronize()
        assert out["chunks_run"] == math.ceil(steps / chunk)
        assert KERNEL.launches == before + out["chunks_run"]
        lsa = dec.attn_cfg.kind == "location_sensitive"
        assert KERNEL.branch_launches["location_sensitive"] == branch + lsa * out["chunks_run"]
        n = one[0].shape[1]
        assert torch.equal(out["mel"][:, :n], one[0])
        assert torch.equal(out["stop_logits"][:, :n], one[1])
        assert torch.equal(out["alignments"][:, :steps], one[2])
        zero = build_model(apply_overrides(cfg, {"model.decoder.stop_threshold": 0.0}),
                           seed=b, device=dev)
        before = KERNEL.launches
        out = chunked_decode(zero, memory, lengths, chunk_steps=chunk, max_steps=steps, seed=9)
        torch.cuda.synchronize()
        assert out["chunks_run"] == 1 and KERNEL.launches == before + 1


@pytest.mark.parametrize("b,t,c,h,bits", [(3, 5, 16, 16, 8), (2, 4, 12, 13, 5), (2, 0, 8, 8, 3),
                                          (33, 3, 20, 37, 6)])  # 33 rows: two launches
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
    assert KERNEL.launches == before + (2 * -(-b // 32) if t else 0)
    assert classes.shape == (b, t * hop) and classes.dtype == torch.int32
    assert torch.equal(classes, again)
    if t:
        assert int(classes.min()) >= 0 and int(classes.max()) < 2 ** bits
        gaps = score_gaps(packed, cond, classes, **kw)
        assert float(gaps.max()) <= 1e-4


def test_wavernn_sample_kernel_at_config_widths(dev):
    """K5 at gst_wavernn's widths (GRU 512, fc 512, 256 classes, hop 256),
    32 streams of 16 frames, held teacher-forced: greedy and sampled, every
    class within 1e-3 of its step's best, also for rows 16-31 alone at
    ``row0`` 16; one launch a call. Sampling is causal: on the first 4
    frames the same seed repeats the first 4 * hop classes, another seed
    does not."""
    from gst_tacotron_tpu_torch.config import load_config
    from gst_tacotron_tpu_torch.ops.wavernn import KERNEL, score_gaps, wavernn_sample
    from gst_tacotron_tpu_torch.weights import build_wavernn

    cfg = load_config("configs/gst_wavernn.json")
    b, frames, hop = 32, 16, cfg.model.vocoder.wavernn_hop
    model = build_wavernn(cfg, seed=3, device=dev)
    g = torch.Generator().manual_seed(frames)
    mel = torch.rand(b, frames, cfg.model.num_mels, generator=g).to(dev)
    with torch.no_grad():
        cond = model.cond_frames(mel).contiguous()
    packed = model.pack()
    before = KERNEL.launches
    greedy = wavernn_sample(packed, cond, hop=hop, greedy=True)
    sampled = wavernn_sample(packed, cond, hop=hop, seed=1)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 2
    for c in (greedy, sampled):
        assert c.shape == (b, frames * hop)
        assert int(c.min()) >= 0 and int(c.max()) < model.num_classes
    head = cond[:, :4].contiguous()
    assert torch.equal(wavernn_sample(packed, head, hop=hop, seed=1), sampled[:, :4 * hop])
    assert not torch.equal(wavernn_sample(packed, head, hop=hop, seed=2), sampled[:, :4 * hop])
    half = b // 2
    rows = wavernn_sample(packed, cond[half:].contiguous(), hop=hop, seed=1, row0=half)
    with torch.no_grad():
        assert float(score_gaps(packed, cond, greedy, hop=hop, greedy=True).max()) <= 1e-3
        assert float(score_gaps(packed, cond, sampled, hop=hop, seed=1).max()) <= 1e-3
        assert float(score_gaps(packed, cond[half:], rows, hop=hop, seed=1,
                                row0=half).max()) <= 1e-3


def test_kernels_at_row0_draw_the_whole_batchs_rows(dev):
    """K4 and K5 on rows 3..4 at ``row0=3`` (a data-parallel rank's rows):
    K4 within 1e-5 of its plain twin at that row0 and of those rows of the
    5-row launch, dropout on; K5 held teacher-forced at that row0, and its
    classes those rows' of the 5-row launch (a row's sums do not depend on
    the launch's rows)."""
    from gst_tacotron_tpu_torch.config import AttentionConfig, DecoderConfig, VocoderConfig
    from gst_tacotron_tpu_torch.models.decoder import DecoderCell
    from gst_tacotron_tpu_torch.models.wavernn import WaveRNN
    from gst_tacotron_tpu_torch.ops.decode import decode_scan, decode_scan_plain
    from gst_tacotron_tpu_torch.ops.wavernn import score_gaps, wavernn_sample
    from gst_tacotron_tpu_torch.weights import init_weights

    dec = DecoderConfig(prenet_dims=(16, 8), attention_rnn_dim=16, decoder_rnn_dim=24,
                        reduction_factor=3, max_decode_steps=7)
    attn = AttentionConfig(dim=12)
    cell = DecoderCell(dec, attn, 10, 20)
    init_weights(cell, seed=3)
    cell = cell.to(dev)
    g = torch.Generator().manual_seed(4)
    memory = rand(g, 5, 9, 20).to(dev)
    with torch.no_grad():
        keys = cell.precompute_keys(memory).contiguous()
    lengths = torch.tensor([9, 0, 4, 7, 9], device=dev)
    kw = dict(dec_cfg=dec, attn_cfg=attn, num_mels=10, steps=7, seed=11, use_dropout=True)
    whole = decode_scan(cell.pack(), memory, keys, lengths, **kw)
    shard = (memory[3:].contiguous(), keys[3:].contiguous(), lengths[3:])
    got = decode_scan(cell.pack(), *shard, row0=3, **kw)
    ref = decode_scan_plain(cell.pack(), *shard, row0=3, **kw)
    for x, y, z in zip(got, ref, whole):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)
        torch.testing.assert_close(x, z[3:], atol=1e-5, rtol=0)

    model = WaveRNN(VocoderConfig(kind="wavernn", wavernn_gru_dim=16, wavernn_fc_dim=16,
                                  wavernn_bits=8, wavernn_hop=4), 6)
    init_weights(model, seed=5)
    model = model.to(dev)
    with torch.no_grad():
        cond = model.cond_frames(torch.rand(5, 4, 6, generator=g).to(dev)).contiguous()
    packed = model.pack()
    skw = dict(hop=4, seed=21, temperature=0.9)
    classes = wavernn_sample(packed, cond, **skw)
    part = wavernn_sample(packed, cond[3:].contiguous(), row0=3, **skw)
    assert torch.equal(part, classes[3:])
    assert float(score_gaps(packed, cond[3:], part, row0=3, **skw).max()) <= 1e-4


def _entry_point_call(name, dev, grad):
    """A call of kernel entry point ``name`` on small CUDA inputs, one of
    which requires grad when ``grad``."""
    from gst_tacotron_tpu_torch.config import (AttentionConfig, AudioConfig, DecoderConfig,
                                               VocoderConfig)
    from gst_tacotron_tpu_torch.models.decoder import DecoderCell
    from gst_tacotron_tpu_torch.models.wavernn import WaveRNN
    from gst_tacotron_tpu_torch.ops import decode, gru, refenc, stft, wavernn
    from gst_tacotron_tpu_torch.weights import init_weights

    g = torch.Generator().manual_seed(1)
    t = lambda *shape: rand(g, *shape, scale=0.3).to(dev).requires_grad_(grad)
    if name in ("gru_scan", "bigru_scan"):
        xs, h0 = t(2, 5, 3), rand(g, 2, 4).to(dev)
        dirs = [(h0, t(3, 12), rand(g, 12).to(dev), t(4, 12), rand(g, 12).to(dev))
                for _ in range(2)]
        if name == "gru_scan":
            return gru.gru_scan(xs, *dirs[0])
        return gru.bigru_scan(xs, dirs[0], dirs[1])
    if name == "refenc_stack":
        kernels = [t(3, 3, 1, 4), t(3, 3, 4, 8)]
        ones = [torch.ones(c, device=dev) for c in (4, 8)]
        return refenc.refenc_stack(t(2, 16, 20), kernels, ones, [0 * o for o in ones])
    if name == "decode_scan":
        dec = DecoderConfig(prenet_dims=(16, 8), attention_rnn_dim=16, decoder_rnn_dim=16)
        attn = AttentionConfig(dim=8)
        cell = DecoderCell(dec, attn, 10, 12)
        init_weights(cell, seed=1)
        cell = cell.to(dev).requires_grad_(grad)
        memory = rand(g, 2, 6, 12).to(dev)
        keys = cell.precompute_keys(memory).detach().contiguous()
        return decode.decode_scan(cell.pack(differentiable=True), memory, keys,
                                  torch.tensor([6, 3], device=dev), dec_cfg=dec,
                                  attn_cfg=attn, num_mels=10, steps=3)
    if name == "wavernn_sample":
        model = WaveRNN(VocoderConfig(kind="wavernn", wavernn_gru_dim=8, wavernn_fc_dim=8,
                                      wavernn_bits=4, wavernn_hop=2), 6)
        init_weights(model, seed=2)
        model = model.to(dev).requires_grad_(grad)
        return wavernn.wavernn_sample(model.pack(differentiable=True),
                                      rand(g, 2, 3, 8).to(dev), hop=2, greedy=True)
    cfg = AudioConfig(n_fft=512, hop_length=128, win_length=512)
    if name == "stft_features_frames":
        return stft.stft_features_frames(t(3, 512), cfg)
    return getattr(stft, name)(t(2, 2048), cfg)


@pytest.mark.parametrize("name", ["gru_scan", "bigru_scan", "refenc_stack", "decode_scan",
                                  "wavernn_sample", "stft_features", "stft_features_fused",
                                  "stft_features_frames"])
def test_kernel_entry_points_refuse_grad(dev, name):
    """No kernel has a backward: with grad mode on, an input that requires
    grad is refused; under torch.no_grad() the same call runs, as it does on
    inputs that need no grad."""
    with pytest.raises(RuntimeError, match="requires grad"):
        _entry_point_call(name, dev, grad=True)
    with torch.no_grad():
        _entry_point_call(name, dev, grad=True)
    _entry_point_call(name, dev, grad=False)
    torch.cuda.synchronize()


def test_alignment_gate_on_the_card(dev, tmp_path):
    """tests/test_alignment_gate.py's gate on the port's ``Trainer`` on the
    card: config 3 at the JAX gate's widths, its token-pattern corpus, 800
    steps; the trained teacher-forced diagonality above 0.85 and more than
    0.3 above the untrained, the loss finite. Then the probe batch's tokens
    synthesized from the trained state (GST off, stop threshold 1.0, the
    probe's frames as the step budget, prenets deterministic): the kernel
    path launches K1 for the two BiGRUs and K4's location-sensitive branch
    once, the plain path nothing, and their mels agree within 2e-3."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.alignment_gate import GATE_STEPS, gate_failures, run_gate
    from gst_tacotron_tpu_torch.config import apply_overrides
    from gst_tacotron_tpu_torch.weights import build_model

    res = run_gate(str(tmp_path), device=dev)
    assert res.steps == GATE_STEPS
    assert not gate_failures(res), res.summary()
    cfg = apply_overrides(res.trainer.cfg, {"model.decoder.stop_threshold": 1.0})
    model = build_model(cfg, seed=0, device=dev).eval()
    model.load_state_dict(res.trainer.state.model.state_dict())
    tok, tok_len = res.probe["tokens"].long(), res.probe["token_lengths"].long()
    steps = res.probe["mel"].shape[1] // cfg.model.decoder.reduction_factor
    mels, launches = [], []
    for plain in (False, True):
        ops.reset_launch_counts()
        with torch.no_grad():
            mels.append(model.infer(tok, tok_len, max_steps=steps, deterministic_prenet=True,
                                    seed=0, plain=plain)["mel"])
        torch.cuda.synchronize()
        launches.append({k: n for k, n in ops.launch_counts().items() if n})
    assert launches == [{"gru_scan": 2, "decode_scan": 1, "decode_scan:location_sensitive": 1},
                        {}]
    assert bool(torch.isfinite(mels[0]).all())
    torch.testing.assert_close(mels[0], mels[1], atol=2e-3, rtol=0)


def test_spans_place_kernels_and_count_copies_on_the_card(dev, tmp_path, monkeypatch):
    """A traced small ``Synthesizer`` call: K4's kernels are launched inside
    ``gst.model.decoder_ar_scan`` (each kernel matched to its launch by
    ``args.correlation``), the call's ``gst.synth`` carries its number, and
    ``d2h_bytes`` is the bytes of the host arrays that ``to_host`` and the
    extractor produced; the host waits once for the result and once for each
    extractor copy."""
    import json
    import os
    import re

    import numpy as np

    from gst_tacotron_tpu_torch.config import load_config
    from gst_tacotron_tpu_torch.dsp.device_features import DeviceFeatureExtractor
    from gst_tacotron_tpu_torch.synthesize import Synthesizer
    from gst_tacotron_tpu_torch.utils import profiling
    from gst_tacotron_tpu_torch.weights import build_model

    cfg = load_config(os.path.join(os.path.dirname(__file__), "fixtures", "golden",
                                   "config.json"))
    synth = Synthesizer(cfg, build_model(cfg, seed=0, device=dev), device=dev)
    rng = np.random.default_rng(0)
    wavs = [rng.uniform(-0.5, 0.5, n * cfg.audio.hop_length).astype(np.float32)
            for n in (20, 33, 150)]
    texts = ["the first sentence.", "a second one.", "third."]
    synth(texts, reference_wavs=wavs, max_steps=8, seed=1)      # builds the kernels
    features = []
    real = DeviceFeatureExtractor._compute

    def compute(self, batch):
        out = real(self, batch)
        features.extend(t.numel() * t.element_size() for t in out)
        return out

    monkeypatch.setattr(DeviceFeatureExtractor, "_compute", compute)
    profiling.reset_counters()
    with profiling.profile_trace(str(tmp_path)):
        out = synth(texts, reference_wavs=wavs, max_steps=8, seed=1)
    counted = profiling.counters()
    host = [v.nbytes for k, v in out.items() if isinstance(v, np.ndarray) and k != "wav_lengths"]
    assert counted["d2h_bytes"] == sum(host) + sum(features)
    assert counted["host_syncs"] == 1 + len(features)

    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    scans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == "gst.model.decoder_ar_scan"]
    assert len(scans) == 1
    assert [e["args"].get("call") for e in events if e.get("cat") == "user_annotation"
            and e["name"] == "gst.synth"] == [profiling.next_call() - 1]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    inside = [e["name"] for e in events if e.get("cat") == "kernel"
              and re.match(r"(void )?decode_", e["name"])
              and scans[0][0] <= launched.get(e["args"].get("correlation"), -1) <= scans[0][1]]
    assert inside
