"""The CUDA designs of K3, K3′ and K3″ (mel-STFT as a shared-memory FFT,
the bf16 modes on wgmma), K1 (GRU scan on thread-block clusters) and K2
(float32 one launch a layer; bf16 one clustered tensor-core launch),
checked on the CPU without a card:

- the STFT kernels' host tables: float64 twiddles rounded once, the live
  window taps, and the sparse mel, which rebuilds the dense basis exactly
  and whose ascending sum gives the dense loop's bits;
- the FFT kernels' n_fft check (every hop | n_fft) and K1's launch plan for
  every GRU of every config and of the golden fixtures, for any H, and the
  shapes it refuses;
- the mixed-radix FFT of K3, K3′ and K3″ (``csrc/fft.cuh::fft_mixed``): a
  numpy emulation of the plan, table, index maps, butterflies and split (or
  unpacked) read against ``np.fft.rfft`` of the windowed frame in float64,
  to 1e-6 of the frame's largest bin (float32 arithmetic, as on the card);
  ``fft_plan``'s table, the frames a block and the scratch mode past the
  shared-memory size;
- the bf16 STFT tile (``csrc/stft_bf16.cuh``): the staged wav span or
  rows, each thread's A fragments, the TMA boxes' 128-byte swizzle and the
  wgmma descriptor's k16 steps over ``wgmma_bases``, the accumulator map
  into the magnitude tile, and the mel's window partials, against the
  bf16-rounded product; ``bf16_plan`` from n_fft 400 to 19711;
- K2's float32 layer kernels: ``layer_plan``'s grids at the main shape, and
  a numpy emulation of a layer's tiles (pixel slots, k parts, SAME padding,
  the length mask) against the plain stack;
- K2's bf16 kernel (``csrc/refenc_bf16.cuh``): ``bf16_plan``, and a float64
  emulation of its launches (the cluster's bands, halo rows read from the
  owning CTA, ldmatrix addresses, ``mma_b_layout`` fragments, k parts)
  against the plain bf16 stack.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from gst_tacotron_tpu_torch.config import AudioConfig, apply_overrides, load_config
from gst_tacotron_tpu_torch.dsp.mel import mel_filterbank
from gst_tacotron_tpu_torch.dsp.ref import padded_window
from gst_tacotron_tpu_torch.models.rnn import GRU
from gst_tacotron_tpu_torch.models.tacotron import GSTTacotron
from gst_tacotron_tpu_torch.ops import gru as tgru
from gst_tacotron_tpu_torch.ops import refenc as trefenc
from gst_tacotron_tpu_torch.ops import stft as tstft
from gst_tacotron_tpu_torch.text.symbols import NUM_SYMBOLS

REPO = Path(__file__).resolve().parent.parent

# n_fft 1024 has an odd log2(n_fft / 2): its last stage is the radix-2 one
FFT_CONFIGS = [dict(n_fft=512, hop_length=128, win_length=512),
               dict(n_fft=512, hop_length=128, win_length=256),
               dict(n_fft=1024, hop_length=256, win_length=1024),
               dict(n_fft=2048, hop_length=256, win_length=1024)]


def _c64(table):
    return (table[:, 0] + 1j * table[:, 1]).astype(np.complex64)


def pow2_table(n_fft: int) -> np.ndarray:
    """The FFT table at a power-of-two n_fft, written out: radix 4 while it
    fits, then one radix 2, each stage's exp(-2 pi i k q / (R p)) q-major,
    then the split twiddles exp(-2 pi i k / n_fft), k = 0..n_fft/2."""
    n = n_fft // 2
    want, p = [], 1
    while 4 * p <= n:
        want += [np.exp(-2j * np.pi * k * q / (4 * p)) for q in (1, 2, 3) for k in range(p)]
        p *= 4
    if p < n:
        want += [np.exp(-1j * np.pi * k / p) for k in range(p)]
    assert len(want) == n - 1
    return np.array(want + [np.exp(-2j * np.pi * k / n_fft) for k in range(n + 1)])


@pytest.mark.parametrize("kw", FFT_CONFIGS, ids=lambda kw: f"{kw['n_fft']}-{kw['win_length']}")
def test_fft_schedule_emulation_matches_rfft(kw):
    """K3's power-of-two configs through the mixed-radix emulation (radix 4,
    one radix 2 last when log2 n is odd)."""
    cfg = AudioConfig(**kw)
    j0, _, n_live = tstft.live_tap_span(cfg)
    n0 = j0 * cfg.hop_length
    tables = tstft.stft_bases(cfg, "cpu")
    radices, _ = tstft.fft_plan(cfg.n_fft)
    assert set(radices) <= {2, 4}
    rng = np.random.default_rng(kw["n_fft"] + kw["win_length"])
    frames = rng.uniform(-1, 1, (8, cfg.n_fft)).astype(np.float32)
    got = emulate_mixed_fft(frames[:, n0:n0 + n_live], tables["fft_window"].numpy(),
                            cfg.n_fft, radices, _c64(tables["fft_twiddle"].numpy()))
    ref = np.fft.rfft(frames.astype(np.float64) * padded_window(cfg.win_length, cfg.n_fft),
                      axis=-1)
    # the taps were rotated by n0 to the start of the frame: a phase per bin
    unrotated = got * np.exp(-2j * np.pi * n0 * np.arange(cfg.num_freq) / cfg.n_fft)
    scale = np.abs(ref).max()
    assert np.abs(unrotated - ref).max() <= 1e-6 * scale
    assert np.abs(np.abs(got) - np.abs(ref)).max() <= 1e-6 * scale


@pytest.mark.parametrize("n_fft", [8, 16, 512, 1024, 2048, 4096])
def test_fft_twiddle_table(n_fft):
    """n_fft entries at a power of two: the stages' exp(-2 pi i k q / (R p)),
    q-major, then the split twiddles; each is its float64 value rounded once
    to float32."""
    _, tw = tstft.fft_plan(n_fft)
    assert tw.shape == (n_fft,)
    np.testing.assert_allclose(tw, pow2_table(n_fft), rtol=0, atol=1e-15)
    cfg = AudioConfig(n_fft=n_fft, hop_length=n_fft // 4, win_length=n_fft)
    table = tstft.stft_bases(cfg, "cpu")["fft_twiddle"].numpy()
    assert table.dtype == np.float32
    np.testing.assert_array_equal(table[:, 0], tw.real.astype(np.float32))
    np.testing.assert_array_equal(table[:, 1], tw.imag.astype(np.float32))


@pytest.mark.parametrize("kw", FFT_CONFIGS, ids=lambda kw: f"{kw['n_fft']}-{kw['win_length']}")
def test_fft_window_is_the_live_taps(kw):
    cfg = AudioConfig(**kw)
    j0, j1, n_live = tstft.live_tap_span(cfg)
    win = padded_window(cfg.win_length, cfg.n_fft)
    got = tstft.stft_bases(cfg, "cpu")["fft_window"].numpy()
    n0 = j0 * cfg.hop_length
    np.testing.assert_array_equal(got, win[n0:n0 + n_live].astype(np.float32))
    assert not np.any(win[:n0]) and not np.any(win[n0 + n_live:])


MEL_CONFIGS = FFT_CONFIGS + [dict(n_fft=64, hop_length=16, win_length=64, num_mels=80)]


def _sparse_dense(kw):
    cfg = AudioConfig(**kw)
    t = tstft.stft_bases(cfg, "cpu")
    return (cfg, t["mel_t"].numpy()[: cfg.num_freq], t["mel_lo"].numpy(), t["mel_off"].numpy(),
            t["mel_w"].numpy())


@pytest.mark.parametrize("kw", MEL_CONFIGS, ids=lambda kw: f"{kw['n_fft']}-{kw['win_length']}")
def test_sparse_mel_rebuilds_the_dense_basis(kw):
    """Scattered back, the sparse tables are ``mel_t`` bit for bit; every
    nonzero is covered (n_fft 64 leaves some of 80 filters empty)."""
    cfg, dense, lo, off, w = _sparse_dense(kw)
    assert lo.dtype == off.dtype == np.int32 and w.dtype == np.float32
    assert off[0] == 0 and np.all(np.diff(off) >= 0) and off[-1] == w.size
    rebuilt = np.zeros_like(dense)
    for m in range(cfg.num_mels):
        rebuilt[lo[m]: lo[m] + off[m + 1] - off[m], m] = w[off[m]: off[m + 1]]
    np.testing.assert_array_equal(rebuilt, dense)
    np.testing.assert_array_equal(
        dense.T, mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.mel_fmin,
                                cfg.mel_fmax))
    if kw["n_fft"] == 64:
        assert np.any(np.diff(off) == 0)


def _fma32(a, b, c):
    """float32 a * b + c from the exact float64 product, rounded to float32."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


@pytest.mark.parametrize("kw", MEL_CONFIGS, ids=lambda kw: f"{kw['n_fft']}-{kw['win_length']}")
def test_sparse_mel_sum_is_the_dense_sum(kw):
    """On random magnitudes, each filter's nonzero bins summed in ascending
    order (the kernel's loop) give the bits of the dense ascending loop over
    every bin (zero weights add nothing), and agree with ``mag @ mel_t``."""
    cfg, dense, lo, off, w = _sparse_dense(kw)
    rng = np.random.default_rng(7)
    mag = (rng.exponential(1.0, (16, cfg.num_freq)) ** 3).astype(np.float32)
    want = np.zeros((16, cfg.num_mels), np.float32)
    for f in range(cfg.num_freq):
        want = _fma32(mag[:, f, None], dense[f][None, :], want)
    got = np.zeros_like(want)
    for m in range(cfg.num_mels):
        for j in range(off[m], off[m + 1]):
            got[:, m] = _fma32(mag[:, lo[m] + j - off[m]], w[j], got[:, m])
    np.testing.assert_array_equal(got, want)
    ref = torch.from_numpy(mag) @ torch.from_numpy(dense)
    np.testing.assert_allclose(got, ref.numpy(), rtol=2e-6, atol=0)


@pytest.mark.parametrize("n_fft", [8, 64, 256, 512, 1024, 2048, 4096])
def test_fft_size_check_takes_powers_of_two(n_fft):
    cfg = AudioConfig(n_fft=n_fft, hop_length=max(1, n_fft // 4), win_length=n_fft)
    smem = tstft.check_fft_size(cfg)
    assert smem == tstft.mixed_fft_smem(n_fft, 1) and 0 < smem <= 232448


@pytest.mark.parametrize("n_fft,hop,win", [(1536, 256, 1024), (1000, 250, 1000),
                                           (4, 1, 4), (8192, 256, 8192)])
def test_fft_size_check_names_the_fused_route(n_fft, hop, win):
    """K3 once refused these (not powers of two, or too large for its
    buffers) and named the "fused" route; on the mixed-radix FFT it takes
    every hop | n_fft: a one-frame block of shared memory, or 0 (the
    device-memory scratch) past MAX_FFT_SIZE."""
    cfg = AudioConfig(n_fft=n_fft, hop_length=hop, win_length=win)
    assert tstft.check_fft_size(cfg) == tstft.mixed_fft_smem(n_fft, 1)
    big = AudioConfig(n_fft=32768, hop_length=256, win_length=2048)
    assert tstft.check_fft_size(big) == 0
    with pytest.raises(ValueError, match="must divide"):
        tstft.check_fft_size(AudioConfig(n_fft=n_fft, hop_length=n_fft - 1, win_length=win))


def _gru_shapes(cfg):
    """(D, H) of every GRU in the model of ``cfg``, built without storage.
    The speaker embedding is not ported and joins the decoder's memory, not
    a GRU's input, so a multi-speaker config is built with one speaker."""
    cfg = apply_overrides(cfg, {"model.num_speakers": 1})
    with torch.device("meta"):
        model = GSTTacotron(cfg.model, cfg.model.num_symbols or NUM_SYMBOLS)
    return sorted({(m.kernel.shape[0], m.features) for m in model.modules()
                   if isinstance(m, GRU)})


CONFIG_FILES = sorted(str(p.relative_to(REPO)) for p in
                      list((REPO / "configs").glob("*.json"))
                      + list((REPO / "tests/fixtures").glob("*/config.json")))


def _check_plan(plan, b, h):
    """The register form up to H = 256 (8 weights a lane a gate up to H =
    128, 16 past it), the streamed form past it; both fit shared memory."""
    assert 1 <= plan["cluster"] <= 8 and plan["cluster"] * plan["units"] >= h
    assert plan["units"] == -(-h // plan["cluster"])
    assert plan["clusters"] * plan["rows"] >= b and plan["clusters"] == -(-b // plan["rows"])
    assert 0 < plan["smem"] <= 232448
    if h <= 256:
        ks, s = plan["ks"], plan["slices"]
        assert ks == (8 if h <= 128 else 16) and plan["kp"] == 0
        assert s & (s - 1) == 0 and 4 <= s <= 16 and s * ks >= h
        assert plan["threads"] % 32 == 0 and plan["units"] * s <= plan["threads"] <= 32 * ks
        assert plan["rows"] == tgru.ROWS
        assert plan["smem"] == 4 * 2 * plan["rows"] * s * ks + 16
    else:
        assert plan["ks"] == 0 and plan["threads"] == tgru.STREAM_THREADS
        groups = -(-plan["units"] // 32)
        assert plan["kp"] == max(1, 8 // groups) and plan["kp"] * min(groups, 8) <= 8
        assert plan["rows"] in (4, 2, 1)
        floats = 2 * plan["rows"] * h + plan["kp"] * plan["rows"] * 3 * plan["units"]
        assert plan["smem"] == 4 * (floats + floats % 2) + 16


@pytest.mark.parametrize("path", CONFIG_FILES)
def test_gru_launch_plan_serves_every_config_gru(path):
    cfg = load_config(str(REPO / path))
    shapes = _gru_shapes(cfg)
    assert shapes, path
    for d, h in shapes:
        for b in (1, 3, 32, 33):
            _check_plan(tgru.launch_plan(b, h), b, h)
    if path == "configs/gst_lj.json":
        # the main path's GRUs (encoder and post-net BiGRUs, reference
        # encoder): 8 CTAs of 16 units, 16 lanes of 8 weights a unit, 8
        # clusters a direction at B=32
        assert shapes == [(128, 128), (256, 128)]
        p = tgru.launch_plan(32, 128)
        assert (p["cluster"], p["units"], p["slices"], p["threads"], p["clusters"]) == \
            (8, 16, 16, 256, 8)


@pytest.mark.parametrize("b,h", [(1, 4), (3, 45), (2, 16), (33, 128), (1, 1), (5, 17),
                                 (2, 120), (0, 128)])
def test_gru_launch_plan_odd_shapes(b, h):
    """H not divisible by the cluster, B not by the rows, tiny H."""
    _check_plan(tgru.launch_plan(b, h), b, h)


@pytest.mark.parametrize("b,h", [(1, 129), (4, 512), (1, 0), (2 * 65536, 128)])
def test_gru_launch_plan_refuses(b, h):
    """H = 129 and 512, once refused (H > 128), now launch; H = 0 and a batch
    past the grid still raise."""
    if h > 0 and b < 65536:
        _check_plan(tgru.launch_plan(b, h), b, h)
        return
    with pytest.raises(ValueError, match="gru_scan"):
        tgru.launch_plan(b, h)


@pytest.mark.parametrize("b,h", [(32, 256), (3, 200), (32, 257), (5, 1000), (2, 4096),
                                 (1, 24465), (7, 9000)])
def test_gru_launch_plan_takes_any_h(b, h):
    """The register form at H = 200 and 256 (16 weights a lane), the streamed
    form past 256, with fewer rows a cluster once four rows' state fills
    shared memory; past H = 24465 even one row's does not."""
    _check_plan(tgru.launch_plan(b, h), b, h)
    if h == 24465:
        with pytest.raises(ValueError, match="shared memory"):
            tgru.launch_plan(b, h + 1)


# ---------------------------------------------------------------------------
# K3′ and K3″: the mixed-radix FFT
# ---------------------------------------------------------------------------

# 1200: 600 = 4·2·3·5·5; 1536: 768 = 4⁴·3; 1026: 513 = 3³·19 (the generic
# stage); 1575 (odd): 3²·5²·7, the unpacked real transform
MIXED_CONFIGS = [dict(n_fft=512, hop_length=128, win_length=512),
                 dict(n_fft=1024, hop_length=256, win_length=1024),
                 dict(n_fft=1200, hop_length=300, win_length=1200),
                 dict(n_fft=1536, hop_length=256, win_length=1024),
                 dict(n_fft=1026, hop_length=342, win_length=1000),
                 dict(n_fft=2048, hop_length=256, win_length=1024),
                 dict(n_fft=1575, hop_length=525, win_length=1500)]


def _dft_small(u):
    """fft.cuh::dft_small's butterflies in complex64 (R = 2, 3, 4, 5)."""
    r = len(u)
    mi = lambda d: (d.imag - 1j * d.real).astype(np.complex64)      # -i d
    f32 = np.float32
    if r == 2:
        return [u[0] + u[1], u[0] - u[1]]
    if r == 3:
        s, d = u[1] + u[2], u[1] - u[2]
        t = (u[0] - f32(0.5) * s).astype(np.complex64)
        rr = mi(f32(0.866025403784438647) * d)
        return [u[0] + s, t + rr, t - rr]
    if r == 4:
        v0, v1, v2, d = u[0] + u[2], u[0] - u[2], u[1] + u[3], u[1] - u[3]
        v3 = mi(d)
        return [v0 + v2, v1 + v3, v0 - v2, v1 - v3]
    c1, c2 = f32(0.309016994374947424), f32(-0.809016994374947424)
    s1, s2 = f32(0.951056516295153572), f32(0.587785252292473129)
    a1, b1, a2, b2 = u[1] + u[4], u[1] - u[4], u[2] + u[3], u[2] - u[3]
    p1, p2 = u[0] + c1 * a1 + c2 * a2, u[0] + c2 * a1 + c1 * a2
    r1, r2 = mi(s1 * b1 + s2 * b2), mi(s2 * b1 - s1 * b2)
    return [u[0] + (a1 + a2), p1 + r1, p2 + r2, p2 - r2, p1 - r1]


def emulate_mixed_fft(live: np.ndarray, window: np.ndarray, n_fft: int, radices,
                      table: np.ndarray) -> np.ndarray:
    """K3′/K3″'s bins of (F, n_live) live-tap frames, in float32 as the
    kernel computes them: the windowed taps rotated to the frame's start,
    packed z[m] = x[2m] + i x[2m+1] (even n_fft) or the real samples (odd),
    the plan's Stockham stages over the table, then the split or a direct
    read of bins 0..n_fft/2."""
    packed = n_fft % 2 == 0
    n = n_fft // 2 if packed else n_fft
    x = np.zeros((live.shape[0], n_fft), np.float32)
    x[:, :live.shape[1]] = live * window
    z = (x[:, 0::2] + 1j * x[:, 1::2] if packed else x + 0j).astype(np.complex64)
    tw, roots, p = table, table[n - 1:], 1
    for r in radices:
        m = n // r
        i = np.arange(m)
        k = i % p
        u = [z[:, i + q * m] for q in range(r)]
        if p > 1:
            u = [u[0]] + [u[q] * tw[(q - 1) * p + k] for q in range(1, r)]
        if r <= 5:
            out = _dft_small(u)
        else:                       # the generic stage: a direct DFT from the roots
            out = []
            for j in range(r):
                acc = u[0]
                for q in range(1, r):
                    acc = acc + u[q] * roots[(j * q) % r]
                out.append(acc)
            roots = roots[r:]
        y = np.empty_like(z)
        for q in range(r):
            y[:, (i - k) * r + k + q * p] = out[q]
        z, tw, p = y, tw[(r - 1) * p:], p * r
    if not packed:
        return z[:, : n_fft // 2 + 1]
    split = table[len(table) - (n + 1):]
    k = np.arange(n + 1)
    a, c = z[:, k % n], z[:, (n - k) % n]
    ev = (0.5 * (a.real + c.real) + 0.5j * (a.imag - c.imag)).astype(np.complex64)
    od = (0.5 * (a.imag + c.imag) - 0.5j * (a.real - c.real)).astype(np.complex64)
    return ev + split[k] * od


@pytest.mark.parametrize("kw", MIXED_CONFIGS, ids=lambda kw: f"{kw['n_fft']}-{kw['win_length']}")
def test_mixed_fft_emulation_matches_rfft(kw):
    cfg = AudioConfig(**kw)
    j0, _, n_live = tstft.live_tap_span(cfg)
    n0 = j0 * cfg.hop_length
    tables = tstft.stft_bases(cfg, "cpu")
    radices, _ = tstft.fft_plan(cfg.n_fft)
    rng = np.random.default_rng(cfg.n_fft + cfg.win_length)
    frames = rng.uniform(-1, 1, (6, cfg.n_fft)).astype(np.float32)
    got = emulate_mixed_fft(frames[:, n0:n0 + n_live], tables["fft_window"].numpy(), cfg.n_fft,
                            radices, _c64(tables["fft_twiddle"].numpy()))
    ref = np.fft.rfft(frames.astype(np.float64) * padded_window(cfg.win_length, cfg.n_fft),
                      axis=-1)
    unrotated = got * np.exp(-2j * np.pi * n0 * np.arange(cfg.num_freq) / cfg.n_fft)
    scale = np.abs(ref).max()
    assert got.shape == ref.shape
    assert np.abs(unrotated - ref).max() <= 1e-6 * scale
    assert np.abs(np.abs(got) - np.abs(ref)).max() <= 1e-6 * scale


@pytest.mark.parametrize("n,count,p,r", [(513, 2, 27, 19), (19, 4, 1, 19), (7, 3, 1, 7),
                                         (1575, 1, 225, 7)])
def test_generic_stage_threads_cover_each_output_once(n, count, p, r):
    """fft.cuh::fft_stage_generic's thread map: e < count * n/R * R splits
    into (j, f, i) with j outermost, each thread writes output
    (i - k) * R + k + j * p of transform f (k = i mod p), and together the
    threads write every output of every transform exactly once."""
    m = n // r
    cm = count * m
    e = np.arange(cm * r)
    j, fi = e // cm, e % cm
    f, i = fi // m, fi % m
    k = i % p
    out = f * n + (i - k) * r + k + j * p
    np.testing.assert_array_equal(np.sort(out), np.arange(count * n))
    assert np.all(np.diff(i[:m]) == 1)            # neighbouring lanes, neighbouring inputs


@pytest.mark.parametrize("n_fft", [2 ** e for e in range(2, 15)])
def test_fft_plan_is_k3s_table_at_powers_of_two(n_fft):
    """At a power of two the plan is radix 4 with at most one radix 2, and its
    table the power-of-two FFT's (so K3 keeps its bits at n_fft 2048)."""
    radices, table = tstft.fft_plan(n_fft)
    assert set(radices) <= {2, 4} and radices.count(2) <= 1
    np.testing.assert_allclose(table, pow2_table(n_fft), rtol=0, atol=1e-15)


@pytest.mark.parametrize("n_fft,radices", [(1200, (4, 2, 3, 5, 5)), (1536, (4, 4, 4, 4, 3)),
                                           (1026, (3, 3, 3, 19)), (1575, (3, 3, 5, 5, 7)),
                                           (2 * 7 * 7 * 11, (7, 7, 11)), (3, (3,))])
def test_fft_plan_tables(n_fft, radices):
    """Stage twiddles, then each generic stage's roots, then (even n_fft) the
    split twiddles: every entry its float64 value."""
    got_r, table = tstft.fft_plan(n_fft)
    assert got_r == radices
    n = n_fft // 2 if n_fft % 2 == 0 else n_fft
    want, roots, p = [], [], 1
    for r in radices:
        want += [np.exp(-2j * np.pi * k * q / (r * p)) for q in range(1, r) for k in range(p)]
        roots += [np.exp(-2j * np.pi * m / r) for m in range(r)] if r > 5 else []
        p *= r
    assert p == n and len(want) == n - 1
    want += roots
    if n_fft % 2 == 0:
        want += [np.exp(-2j * np.pi * k / n_fft) for k in range(n + 1)]
    np.testing.assert_allclose(table, np.array(want), rtol=0, atol=1e-15)


def test_fft_frames_per_block_and_size_limit():
    """2 frames a block at the main path's 1024 frames, 1 for a short
    KernelDSP call, 4 for long inputs, so the grid gives each SM two blocks;
    n_fft up to 29056 (even), 14527 (odd) in shared memory: beyond, 0 frames
    (the device-memory scratch, two blocks an SM, at most one a frame)."""
    fpb = tstft.fft_frames_per_block
    assert fpb(2048, 1, 1024, 132) == 2
    assert fpb(2048, 8, 128, 132) == 2
    assert fpb(2048, 32, 800, 132) == 4
    assert fpb(2048, 1, 600, 132) == 2
    assert fpb(2048, 1, 300, 132) == 1
    assert fpb(2048, 1, 100, 132) == 1
    assert fpb(16384, 1, 1024, 132) == 1          # 131 KB a frame
    for n_fft in (16384, 29056, 14527, 1575):
        assert tstft.mixed_fft_smem(n_fft, fpb(n_fft, 1, 4096, 132)) <= 232448
    for n_fft in (29058, 32768, 14529):
        assert fpb(n_fft, 1, 1024, 132) == 0
    assert tstft.MAX_FFT_SIZE == {"even": 29056, "odd": 14527}
    assert tstft.scratch_slots(8, 128, 132) == 33
    assert tstft.scratch_slots(1, 1024, 132) == 264
    assert tstft.scratch_slots(64, 3, 132) == 3


# ---------------------------------------------------------------------------
# The bf16 STFT kernel (K3's bf16 mode, K3′'s bf16 bases): wgmma on TMA-fed bases
# ---------------------------------------------------------------------------


def _bf16_values(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16) \
        .to(torch.float32).numpy()


def _bf16_as_float(bits):
    """bf16 bit patterns (int16) as float64."""
    u = (np.asarray(bits).astype(np.int64) & 0xFFFF) << 16
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _pair(reg):
    """The two bf16 halves of int32 registers as float64 (low half first)."""
    u = np.asarray(reg).astype(np.int64) & 0xFFFFFFFF
    return _bf16_as_float(u & 0xFFFF), _bf16_as_float(u >> 16)


def _staged_taps(wav, plan, t0, hop, n0, n_live, chunk=0):
    """The kernel's staged taps (load_span / load_chunk) as float64: the 64
    frames' wav span in hop-long segments at the plan's stride, or chunk
    ``chunk`` of each frame's taps as rows; bf16-rounded, zero past the
    wav and (rows) the live taps."""
    kp, stride = plan["kp"], plan["stride"]
    r = lambda v: _bf16_values(np.asarray(v, np.float32)).astype(np.float64)
    if plan["span"]:
        nseg = 64 + (kp - 1) // hop
        out = np.full(nseg * stride, np.nan)
        i = np.arange(nseg * hop)
        s = t0 * hop + n0 + i
        out[(i // hop) * stride + i % hop] = r(np.where(s < len(wav), wav[np.minimum(s, len(wav) - 1)], 0))
        return out
    kch = plan["kch"]
    out = np.full(64 * stride, np.nan)
    rr, e = np.divmod(np.arange(64 * kch), kch)
    k = chunk * kch + e
    s = (t0 + rr) * hop + n0 + k
    ok = (k < n_live) & (s < len(wav))
    out[rr * stride + e] = r(np.where(ok, wav[np.minimum(s, len(wav) - 1)], 0))
    return out


def _a_fragments(wav, plan, t0, hop, n0, n_live, ksteps):
    """Each consumer thread's A registers, k16 step by k16 step, through the
    kernel's address arithmetic (the span's per-thread (segment, offset)
    trackers, or the chunk's row offsets), rebuilt as the 64 x 16 A tiles
    of mma.m16n8k16's layout a warp (rows 16w + g, + 8; taps 2t, + 8)."""
    w, lane = np.divmod(np.arange(128), 32)
    g, t = lane // 4, lane % 4
    r0 = 16 * w + g
    stride = plan["stride"]
    qa, ra = (2 * t) // hop, (2 * t) % hop
    qb, rb = (2 * t + 8) // hop, (2 * t + 8) % hop
    chunks = 1 if plan["span"] else -(-plan["kp"] // plan["kch"])
    staged = _staged_taps(wav, plan, t0, hop, n0, n_live)
    kl = 0
    tiles = []
    for ks in range(ksteps):
        if not plan["span"] and chunks > 1 and (ks * 64) % plan["kch"] == 0:
            staged = _staged_taps(wav, plan, t0, hop, n0, n_live, ks * 64 // plan["kch"])
            kl = 0
        for _ in range(4):
            if plan["span"]:
                pa, pb = (r0 + qa) * stride + ra, (r0 + qb) * stride + rb
                ra = ra + 16
                qa, ra = qa + ra // hop, ra % hop
                rb = rb + 16
                qb, rb = qb + rb // hop, rb % hop
            else:
                pa = r0 * stride + kl + 2 * t
                pb = pa + 8
                kl += 16
            tile = np.full((64, 16), np.nan)
            for reg, (addr, dr) in enumerate([(pa, 0), (pa + 8 * stride, 8), (pb, 0),
                                              (pb + 8 * stride, 8)]):
                col = 2 * t + (8 if reg >= 2 else 0)
                tile[r0 + dr, col] = staged[addr]
                tile[r0 + dr, col + 1] = staged[addr + 1]
            tiles.append(tile)
    return np.concatenate(tiles, axis=1)


def _b_tiles(bases_bits, win, ks):
    """The TMA boxes of ring stage (win, ks), cos and sin (144 bin rows x 64
    taps, each row's 16-byte chunk c at c ^ (row % 8): the 128-byte
    swizzle), read back as wgmma's four k16 steps see them through the
    descriptor (start + 32 bytes a step, the same swizzle of the address):
    two (64 taps x 144 bins) B matrices."""
    out = []
    nfw = bases_bits.shape[0] // 2
    for row0 in (win * 144, nfw + win * 144):
        box = bases_bits[row0:row0 + 144, ks * 64:(ks + 1) * 64]
        image = np.zeros((144, 8, 8), np.int64)
        n = np.arange(144)[:, None]
        image[n, np.arange(8)[None, :] ^ (n % 8)] = box.reshape(144, 8, 8)
        b = np.zeros((64, 144))
        for s in range(4):
            for kk in range(16):
                chunk = (2 * s + kk // 8) ^ (np.arange(144) % 8)
                b[16 * s + kk] = _bf16_as_float(image[np.arange(144), chunk, kk % 8])
        out.append(b)
    return out


@pytest.mark.parametrize("n_fft,hop,win", [(2048, 256, 1024), (400, 100, 400),
                                           (1575, 525, 1500), (6144, 1536, 4608)])
def test_bf16_tile_fragment_maps(n_fft, hop, win):
    """The bf16 kernel's first frame tile, lane by lane: the A fragments
    from the staged span (n_fft 2048, 400: even hops) or rows (odd hop 525;
    6144, whose span does not fit: chunks of 256 taps) equal the frames'
    bf16 taps; the swizzled TMA boxes read through the descriptor's k16
    steps equal ``wgmma_bases``; the two warpgroups' accumulators (72 bins
    each), scattered as the epilogue does (fragment 4j + i: row r0 + 8 *
    (i / 2), bin 72 * half + 8j + 2t + i % 2), give every magnitude of the
    tile once; the mel (each filter's share of window w taken by CTA w: in
    the bf16 mode a tensor-core product of the packed bf16 magnitudes and
    the window's mel fragments, every partial written once; then the window
    partials added in ascending order by the CTA that owns the frame) gives
    the plain bf16 version's mel (float64 sums here: within float32
    rounding)."""
    cfg = AudioConfig(n_fft=n_fft, hop_length=hop, win_length=win)
    j0, _, n_live = tstft.live_tap_span(cfg)
    n0 = j0 * hop
    plan = tstft.bf16_plan(n_fft, hop, n_live, cfg.num_mels)
    assert plan["span"] == (n_fft in (2048, 400))
    rng = np.random.default_rng(n_fft)
    frames = 70
    wav = (rng.uniform(-1, 1, n_fft + hop * (frames - 1)) * 0.4).astype(np.float32)
    ksteps = plan["kp"] // 64
    a = _a_fragments(wav, plan, 0, hop, n0, n_live, ksteps)
    want_a = np.zeros((64, plan["kp"]))
    for r in range(64):
        want_a[r, :n_live] = wav[r * hop + n0: r * hop + n0 + n_live]
    want_a = _bf16_values(want_a.astype(np.float32))
    live = np.arange(plan["kp"]) < n_live
    np.testing.assert_array_equal(a[:, live], want_a[:, live])
    assert np.isfinite(a).all()

    cos_b, sin_b = tstft.dft_bases(cfg, "cpu")
    bits = tstft.wgmma_bases(cos_b, sin_b, plan["windows"], plan["kp"]).view(torch.int16).numpy()
    nf = cfg.num_freq
    mags = np.zeros((64, plan["windows"] * 144))
    writes = np.zeros_like(mags, int)
    warp, lane = np.divmod(np.arange(256), 32)       # the two consumer warpgroups
    half, g, t = warp >> 2, lane // 4, lane % 4
    r0 = 16 * (warp & 3) + g
    for win in {0, plan["windows"] - 1}:
        acc = [np.zeros((64, 144)), np.zeros((64, 144))]
        for ks in range(ksteps):
            bc, bs = _b_tiles(bits, win, ks)
            acc[0] += a[:, 64 * ks:64 * ks + 64] @ bc
            acc[1] += a[:, 64 * ks:64 * ks + 64] @ bs
        # each warpgroup's accumulator fragments (wgmma's D layout over its
        # 72 bins, the boxes' rows 72 * half on), then the epilogue's map
        # into the magnitude tile
        for j in range(9):
            for i in range(4):
                row, col = r0 + 8 * (i // 2), 72 * half + 8 * j + 2 * t + i % 2
                re, im = acc[0][row, col], acc[1][row, col]
                mags[r0 + 8 * (i // 2), win * 144 + 72 * half + 8 * j + 2 * t + i % 2] = \
                    np.sqrt(re * re + im * im)
                writes[row, win * 144 + col] += 1
        assert (writes[:, win * 144:(win + 1) * 144] == 1).all()
    frames_bf = want_a[:, :n_live].astype(np.float64)
    c64, s64 = (_bf16_values(x.numpy()).astype(np.float64) for x in (cos_b, sin_b))
    want = np.sqrt((frames_bf @ c64) ** 2 + (frames_bf @ s64) ** 2)
    for win in {0, plan["windows"] - 1}:
        sl = slice(win * 144, min(nf, (win + 1) * 144))
        np.testing.assert_allclose(mags[:, sl], want[:, sl], rtol=1e-12, atol=1e-12)

    if plan["scratch"] or n_fft != 2048:
        return
    # the mel (one window a CTA): CTA w sums each filter's bins of window w in
    # ascending order for every row; CTA rank adds, for its frames
    # [rank * fpr, ...), each filter's window partials in ascending order
    for win in range(plan["windows"]):
        sl = slice(win * 144, (win + 1) * 144)
        mags[:, sl] = want[:, sl] if win < plan["windows"] - 1 else \
            np.pad(want[:, win * 144:], ((0, 0), (0, (win + 1) * 144 - nf)))
    tables = tstft._fft_tables_np(cfg)
    lo, off, mw = tables["mel_lo"], tables["mel_off"], _bf16_values(tables["mel_w"])
    m_n = cfg.num_mels
    parts = np.zeros((plan["windows"], 64, m_n))
    for w in range(plan["windows"]):
        b0 = w * 144
        for m in range(m_n):
            c0, c1 = max(lo[m], b0), min(lo[m] + off[m + 1] - off[m], b0 + 144)
            if c0 < c1:
                seg = _bf16_values(mags[:, c0:c1].astype(np.float32)).astype(np.float64)
                parts[w, :, m] = seg @ mw[off[m] + c0 - lo[m]: off[m] + c1 - lo[m]]
    # the bf16 mode's partials as the kernel takes them: warp w's A
    # fragments packed from the tile (rows 16 (w % 4) + g, + 8; bins 16s +
    # 2t, + 8), its half of the n8 tiles of the window's mel fragments, and
    # each fragment stored to (row, filter); every partial written once
    melf = tstft._bf16_bases(cfg, "cpu")[plan["mel_frag"] * 2:].numpy().reshape(
        plan["windows"], plan["mel_nt"], 9, 32, 2)
    nt_n = plan["mel_nt"]
    for w in range(plan["windows"]):
        tile = _bf16_values(mags[:, w * 144:(w + 1) * 144].astype(np.float32)).astype(np.float64)
        got_p = np.full((64, m_n), np.nan)
        for warp in range(8):
            lane = np.arange(32)
            g, t = lane // 4, lane % 4
            r0 = (warp & 3) * 16 + g
            nh = (nt_n + 1) // 2
            nt0 = (warp >> 2) * nh
            for j in range(min(nh, nt_n - nt0)):
                bmat = _mma_b_matrix(melf[w, nt0 + j], 9, 1)          # (144, 8)
                acc = np.zeros((32, 4))
                for s9 in range(9):
                    a = np.zeros((16, 16))
                    for dr, dc, in [(0, 0), (8, 0), (0, 8), (8, 8)]:
                        for e in range(2):
                            a[g + dr, 2 * t + dc + e] = tile[r0 + dr, 16 * s9 + 2 * t + dc + e]
                    c = a @ bmat[16 * s9:16 * s9 + 16]
                    for i in range(4):
                        acc[:, i] += c[g + 8 * (i // 2), 2 * t + i % 2]
                for i in range(4):
                    m = (nt0 + j) * 8 + 2 * t + i % 2
                    ok = m < m_n
                    assert np.isnan(got_p[(r0 + 8 * (i // 2))[ok], m[ok]]).all()
                    got_p[(r0 + 8 * (i // 2))[ok], m[ok]] = acc[ok, i]
        np.testing.assert_allclose(got_p, parts[w], rtol=1e-12, atol=1e-12)
    cw = plan["cw"]
    fpr = -(-64 // cw)
    mel = np.zeros((64, m_n))
    covered = np.zeros((64, m_n), int)
    for rank in range(cw):
        for rl in range(fpr):
            r = rank * fpr + rl
            for m in range(m_n):
                n = off[m + 1] - off[m]
                for w in range(lo[m] // 144, (lo[m] + n - 1) // 144 + 1) if n else ():
                    mel[r, m] += parts[w, r, m]
                covered[r, m] += 1
    assert (covered == 1).all()
    wav_t = torch.from_numpy(wav[None])
    ref = tstft.stft_features_plain(wav_t, cfg, bf16=True)[0][0, :64].numpy()
    got = tstft.db_normalize(torch.from_numpy(mel), cfg).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_bf16_launch_plan():
    """``bf16_plan`` from n_fft 400 to 19711: 144-bin windows, clusters of
    the next power of two of them (at most 8: 8 at n_fft 2048, 128 CTAs for
    the main path's 1024 frames), one window a CTA up to 8 windows and the
    device-memory scratch past them; the wav span where hop is even and it
    fits (the main path: 67 segments at stride 264, 35 KB), else rows of a
    multiple of 64 taps; segments and rows at a stride of 8 mod 64 (the 8
    rows of a fragment on 8 bank groups); two CTAs fit an SM. No n_fft past the old 19711 limit is refused. The bases
    are built at the first bf16 call, not among ``stft_bases``."""
    main = tstft.bf16_plan(2048, 256, 1024, 80)
    assert main == {"windows": 8, "cw": 8, "kp": 1024, "span": 1, "stride": 264, "kch": 0,
                    "stages": 2, "scratch": 0, "a_bytes": 35376, "smem": 110160,
                    "mel_nt": 10, "mel_frag": 8 * 144 * 1024 // 2}
    assert (tstft.BF16_TILE, tstft.BF16_WINDOW, tstft.BF16_K) == (64, 144, 64)
    for n_fft in (400, 512, 1024, 1026, 1200, 1536, 1575, 2048, 4096, 4863, 4864, 6144, 8192,
                  9727, 9728, 15625, 19711, 19712, 32768):
        for hop in (n_fft // 4, n_fft // 8 if n_fft % 8 == 0 else n_fft // 4):
            win = n_fft - hop
            cfg = AudioConfig(n_fft=n_fft, hop_length=hop, win_length=win)
            n_live = tstft.live_tap_span(cfg)[2]
            p = tstft.bf16_plan(n_fft, hop, n_live, 80)
            assert p["windows"] * 144 >= n_fft // 2 + 1 > (p["windows"] - 1) * 144
            assert p["cw"] in (1, 2, 4, 8) and p["cw"] >= min(p["windows"], 8)
            assert p["scratch"] == int(p["windows"] > p["cw"])
            assert p["kp"] % 64 == 0 and p["kp"] - 64 < n_live <= p["kp"]
            assert 2 * (p["smem"] + 1024) <= 233472 and p["stride"] % 64 == 8   # two CTAs an SM
            if p["span"]:
                assert hop % 2 == 0
                assert p["a_bytes"] >= (64 + (p["kp"] - 1) // hop) * p["stride"] * 2
            else:
                assert p["kch"] % 64 == 0 and p["kch"] >= 64 and p["stride"] == p["kch"] + 8
            assert p["a_bytes"] % 16 == 0
    assert tstft.bf16_plan(1575, 525, 1500, 80)["span"] == 0          # odd hop: rows
    assert tstft.bf16_plan(6144, 1536, 4608, 80)["kch"] == 256        # the span would not fit
    # 143 mels: the partial sums do not fit the ring past the tile
    assert [tstft.bf16_plan(2048, 256, 1024, m)["scratch"] for m in (142, 143)] == [0, 1]
    cfg = AudioConfig(n_fft=512, hop_length=128, win_length=512)
    assert not any("bf16" in k for k in tstft.stft_bases(cfg, "cpu"))
    wb = tstft._bf16_bases(cfg, "cpu")
    plan = tstft.bf16_plan(512, 128, 512, 80)
    cos_b, sin_b = tstft.dft_bases(cfg, "cpu")
    nfw, nt = plan["windows"] * 144, plan["mel_nt"]
    assert wb.dtype == torch.int32 and plan["mel_frag"] * 2 == nfw * 512 and nt == 10
    np.testing.assert_array_equal(
        wb[:nfw * 512].numpy(),
        tstft.wgmma_bases(cos_b, sin_b, plan["windows"], 512).view(torch.int32).reshape(-1))
    # then each window's 144 rows of the mel basis, bf16, as mma B fragments
    frags = wb[plan["mel_frag"] * 2:].numpy().reshape(plan["windows"], nt, 9, 32, 2)
    mel_t = np.zeros((nfw, 8 * nt), np.float32)
    mel_t[:, :80] = tstft._mel_t_np(cfg)[:nfw]
    for w in range(plan["windows"]):
        np.testing.assert_array_equal(_mma_b_matrix(frags[w], 9, nt),
                                      _bf16_values(mel_t[w * 144:(w + 1) * 144]))
    assert tstft.bf16_plan(2048, 256, 1024, 129)["mel_nt"] == 0       # past 128 mels: the sums


def test_bf16_fragments_use_torchs_rounding():
    """The host rounds the bf16 kernels' operands as ``round_bf16`` (torch's
    cast, ties to even): the STFT bases of ``wgmma_bases`` and K2's taps in
    ``mma_b_layout``, whose registers hold B[2t, g], B[2t+1, g] (low half
    first) and B[2t+8, g], B[2t+9, g] of lane 4g + t."""
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -2.5e-3, 3e38, 0.0], np.float32)
    want = tstft.round_bf16(torch.from_numpy(x)).numpy()
    cos_b = torch.from_numpy(np.tile(x, (16, 1))[:, :6])           # (n_live 16, 6 bins)
    wb = tstft.wgmma_bases(cos_b, cos_b, 1, 64).view(torch.int16).numpy()
    np.testing.assert_array_equal(_bf16_as_float(wb[:6, 0]), want)
    np.testing.assert_array_equal(wb[6:144], 0)
    b = torch.from_numpy(np.resize(x, (32, 16)).astype(np.float32))
    frag = trefenc.mma_b_layout(b).numpy()
    assert frag.shape == (2, 2, 32, 2) and frag.dtype == np.int32
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    rb = tstft.round_bf16(b).numpy()
    for nt in range(2):
        for ks in range(2):
            lo0, hi0 = _pair(frag[nt, ks, :, 0])
            lo1, hi1 = _pair(frag[nt, ks, :, 1])
            col = nt * 8 + g
            np.testing.assert_array_equal(lo0, rb[16 * ks + 2 * t, col])
            np.testing.assert_array_equal(hi0, rb[16 * ks + 2 * t + 1, col])
            np.testing.assert_array_equal(lo1, rb[16 * ks + 2 * t + 8, col])
            np.testing.assert_array_equal(hi1, rb[16 * ks + 2 * t + 9, col])


# ---------------------------------------------------------------------------
# K2: one launch a layer
# ---------------------------------------------------------------------------


def test_refenc_layer_plan_spreads_each_layer():
    """float32: at the main shape every layer gives the 132 SMs two blocks
    each; the late layers split their input-channel sums (ks) to get there.
    bf16: one launch for the whole stack, clusters of 4 CTAs an utterance
    (128 CTAs for 32 utterances), each owning 16, 8, 4, 2, 1, 1 rows of the
    six layers; the late layers' few units split their taps into k parts."""
    plan = trefenc.layer_plan(32, 128, 80, [32, 32, 64, 64, 128, 128], 132)
    assert [p["blocks"] for p in plan] == [2560, 640, 320, 320, 384, 512]
    assert [(p["ks"], p["px"]) for p in plan] == [(1, 4), (1, 4), (1, 4), (2, 2), (2, 1),
                                                   (8, 1)]
    assert [p["shape"] for p in plan][-1] == (2, 2, 128)
    small = trefenc.layer_plan(1, 19, 16, [4, 4, 8], 132)
    c_in = [1, 4, 4]
    for p, c in zip(small, c_in):
        assert trefenc.GROUPS % p["ks"] == 0 and p["ks"] <= c and p["px"] in (1, 2, 4)
    bf = trefenc.bf16_plan(128, 80, [32, 32, 64, 64, 128, 128])
    assert [(q["l0"], q["l1"], q["bands"]) for q in bf["launches"]] == [(0, 6, 4)]
    assert bf["launches"][0]["smem"] <= 232448
    assert bf["bh"] == [16, 8, 4, 2, 1, 1] and bf["ks"] == [1, 1, 1, 4, 2, 2]
    # the plan depends on the shape alone: any batch gives the same launches
    assert trefenc.bf16_plan(128, 80, [32, 32, 64, 64, 128, 128]) == bf


def emulate_refenc_layer(x, kern, scale, bias, lengths, ks, px):
    """``refenc_layer_kernel``'s tiles over one layer, in float64: block bx
    of utterance b and channel tile, warp g = (slot, k part), lane = output
    channel; each (pixel, k part) partial sum over its input channels, the
    parts added in order, then scale, bias, ReLU. Returns the output and a
    count of writes per output."""
    b, hi, wi, ci = x.shape
    co = kern.shape[-1]
    ho, wo = (hi + 1) // 2, (wi + 1) // 2
    top, left = max(0, 2 * (ho - 1) + 3 - hi) // 2, max(0, 2 * (wo - 1) + 3 - wi) // 2
    vec = 4 if ci % 4 == 0 else 1
    slots, npix = trefenc.GROUPS // ks, ho * wo
    cper = -(-(-(-ci // ks)) // vec) * vec
    out = np.zeros((b, npix, co))
    writes = np.zeros((b, npix), int)
    for bb in range(b):
        row_lim = min(hi, lengths[bb]) if lengths is not None else hi
        for bx in range(-(-npix // (slots * px))):
            for slot in range(slots):
                for i in range(px):
                    p = bx * slots * px + slot * px + i
                    if p >= npix:
                        continue
                    oi, oq = divmod(p, wo)
                    parts = []
                    for kpart in range(ks):
                        c0 = min(ci, kpart * cper)
                        c1 = min(ci, c0 + cper)
                        acc = np.zeros(co)
                        for di in range(3):
                            for dj in range(3):
                                u, v = 2 * oi + di - top, 2 * oq + dj - left
                                if 0 <= u < row_lim and 0 <= v < wi:
                                    acc += x[bb, u, v, c0:c1] @ kern[di, dj, c0:c1]
                        parts.append(acc)
                    out[bb, p] = np.maximum(sum(parts) * scale + bias, 0.0)
                    writes[bb, p] += 1
    return out.reshape(b, ho, wo, co), writes


@pytest.mark.parametrize("t,f,channels,lengths", [(19, 16, (4, 8, 8), (19, 7)),
                                                  (24, 12, (8, 12, 16), None)])
def test_refenc_layer_emulation_matches_plain(t, f, channels, lengths):
    """Every layer of a small stack through the emulated tiles of its
    ``layer_plan`` (several k parts and pixel counts): each output written
    once, the plain stack's values to 1e-5."""
    rng = np.random.default_rng(t)
    x = rng.uniform(0, 1, (2, t, f, 1))
    lens = None if lengths is None else np.array(lengths)
    kerns, scales, biases, c_in = [], [], [], 1
    for c in channels:
        kerns.append(rng.uniform(-0.3, 0.3, (3, 3, c_in, c)))
        scales.append(rng.uniform(0.5, 1.5, c))
        biases.append(rng.normal(0, 0.1, c))
        c_in = c
    plan = trefenc.layer_plan(2, t, f, channels, 132)
    splits = set()
    act = x
    for layer, (kern, sc, bi, p) in enumerate(zip(kerns, scales, biases, plan)):
        for ks, px in {(p["ks"], p["px"]), (min(2, act.shape[-1]), 2)}:
            got, writes = emulate_refenc_layer(act, kern, sc, bi,
                                               lens if layer == 0 else None, ks, px)
            assert np.all(writes == 1)
            splits.add((ks, px))
        act = got
    t32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    ref = trefenc.refenc_stack_plain(
        t32(x[..., 0]), [t32(k) for k in kerns], [t32(v) for v in scales],
        [t32(v) for v in biases], lengths=None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(act.reshape(ref.shape), ref.numpy(), atol=1e-5)
    assert len(splits) > 1


# ---------------------------------------------------------------------------
# K2 bf16: one clustered tensor-core launch (csrc/refenc_bf16.cuh)
# ---------------------------------------------------------------------------


def _r16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).to(torch.float64).numpy()


def _mma_b_matrix(table, ks_n, nt_n):
    """A (K, N) B matrix back from ``mma_b_layout``'s fragments through the
    PTX layout (lane 4g + t: register 0 rows 2t, 2t + 1, register 1 rows
    2t + 8, 2t + 9, of column g of its n8 tile)."""
    frag = table.reshape(nt_n, ks_n, 32, 2)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = np.full((ks_n * 16, nt_n * 8), np.nan)
    for nt in range(nt_n):
        for k in range(ks_n):
            lo0, hi0 = _pair(frag[nt, k, :, 0])
            lo1, hi1 = _pair(frag[nt, k, :, 1])
            col = nt * 8 + g
            out[16 * k + 2 * t, col], out[16 * k + 2 * t + 1, col] = lo0, hi0
            out[16 * k + 2 * t + 8, col], out[16 * k + 2 * t + 9, col] = lo1, hi1
    return out


def emulate_refenc_bf16(mel, lengths, kernels, scales, biases, plan):
    """``refenc_bf16_kernel``'s launches of ``plan`` in float64: per
    utterance and band CTA, each layer's staged input rows (zero-padded
    pixels, taken from the CTA that owns each row, or from the previous
    launch's device-memory activation), layer 0 on the CUDA cores, layers
    1+ as warp items (16 pixels x 32 channels x a k part) whose A tiles come
    from the lanes' ldmatrix addresses into the flat staging buffer and
    whose B tiles from ``bf16_tap_tables``, k parts added in order, the
    epilogue through the accumulator map; outputs stored once each (bf16
    between layers, float32 at the end). Returns the output and the count
    of writes of each final output."""
    b_n, t, f = mel.shape
    channels = [k.shape[-1] for k in kernels]
    shapes = trefenc.stack_shapes(t, f, channels)
    n = len(shapes)
    tables = trefenc.bf16_tap_tables([torch.from_numpy(k) for k in kernels]).numpy()
    taps, off = [None], 0
    for s in shapes[1:]:
        ks_n, nt_n = 9 * s["cip"] // 16, s["cop"] // 8
        size = ks_n * nt_n * 32 * 2
        taps.append(_mma_b_matrix(tables[off:off + size], ks_n, nt_n))
        off += size
    last = shapes[-1]
    out = np.full((b_n, last["ho"], last["wo"] * last["co"]), np.nan)
    writes = np.zeros(out.shape, int)
    acts = {}                                  # device-memory activations between launches
    lane = np.arange(32)
    g, t4 = lane // 4, lane % 4
    for q in plan["launches"]:
        for b in range(b_n):
            parts = {}                         # (layer, band) -> the band's bf16 outputs
            for l in range(q["l0"], q["l1"]):
                y = shapes[l]
                bh, ks = plan["bh"][l], plan["ks"][l]
                top = max(0, 2 * (y["ho"] - 1) + 3 - y["hi"]) // 2
                left = max(0, 2 * (y["wo"] - 1) + 3 - y["wi"]) // 2
                sc, bi = scales[l].astype(np.float64), biases[l].astype(np.float64)
                for band in range(q["bands"]):
                    i0 = min(y["ho"], band * bh)
                    i1 = min(y["ho"], i0 + bh)
                    npx, u0, nr = (i1 - i0) * y["wo"], 2 * i0 - top, 2 * (i1 - i0) + 1
                    if npx == 0:
                        continue
                    res = np.full((npx, y["cop"]), np.nan)

                    def store(p, o, v):
                        res[p, o] = v if o < y["co"] else 0.0

                    epi = lambda o, a: max(a * sc[o] + bi[o], 0.0) if o < y["co"] else 0.0
                    ws = y["wi"] + 2
                    if l == 0:
                        lim = min(y["hi"], lengths[b]) if lengths is not None else y["hi"]
                        stg = np.zeros((nr, ws))
                        for r in range(nr):
                            u = u0 + r
                            if 0 <= u < lim:
                                stg[r, 1:f + 1] = _r16(mel[b, u])
                        k0 = _r16(kernels[0].reshape(9, -1))
                        for p in range(npx):
                            i, qq = divmod(p, y["wo"])
                            x = [stg[2 * i + tap // 3, 2 * qq + tap % 3 - left + 1]
                                 for tap in range(9)]
                            for o in range(y["cop"]):
                                acc = sum(x[tap] * k0[tap, o] for tap in range(9)) \
                                    if o < y["co"] else 0.0
                                store(p, o, epi(o, acc))
                    else:
                        cip = y["cip"]
                        ps = cip + 8
                        stg = np.full((nr, ws, ps), np.nan)
                        stg[:, :, :cip] = 0.0
                        prev = plan["bh"][l - 1]
                        for r in range(nr):
                            u = u0 + r
                            if not 0 <= u < y["hi"]:
                                continue
                            if l == q["l0"]:
                                stg[r, 1:y["wi"] + 1, :cip] = acts[l - 1][b, u]
                            else:      # the owner of row u, read across the cluster
                                owner = u // prev
                                stg[r, 1:y["wi"] + 1, :cip] = parts[(l - 1, owner)][u - owner * prev]
                        flat = stg.reshape(-1)
                        KS, cpt = 9 * cip // 16, cip // 16
                        mt, ng = -(-npx // 16), -(-y["cop"] // 32)
                        red = {}
                        for item in range(mt * ng * ks):
                            unit, kpart = divmod(item, ks)
                            mtile, grp = divmod(unit, ng)
                            nt0, ntl = grp * 4, min(4, y["cop"] // 8 - grp * 4)
                            pa = mtile * 16 + (lane & 15)
                            valid = pa < npx
                            ia, qa = np.where(valid, pa // y["wo"], 0), np.where(valid, pa % y["wo"], 0)
                            abase = np.where(valid, 2 * ia * ws + 2 * qa - left + 1, 0) * ps \
                                + (lane >> 4) * 8
                            acc = np.zeros((16, 32))
                            s0, s1 = kpart * KS // ks, (kpart + 1) * KS // ks
                            # the kernel's walk: the address of step s0, then 16
                            # channels a step, the next tap (dj, then di) past a tap
                            tap, c16 = divmod(s0, cpt)
                            dj = tap % 3
                            off = np.where(valid, ((tap // 3) * ws + dj) * ps, 0)
                            addr0 = abase + off + 16 * c16
                            for ss in range(s0, s1):
                                assert (addr0 == abase + np.where(
                                    valid, ((ss // cpt // 3) * ws + ss // cpt % 3) * ps, 0)
                                    + 16 * (ss % cpt)).all()
                                addr = addr0
                                tap = ss // cpt
                                a = np.zeros((16, 16))
                                for ln in range(32):     # ldmatrix.x4: lane ln's 8-element row
                                    a[ln & 15, 8 * (ln >> 4):8 * (ln >> 4) + 8] = \
                                        flat[addr[ln]:addr[ln] + 8]
                                bt = taps[l][16 * ss:16 * ss + 16, nt0 * 8:(nt0 + ntl) * 8]
                                acc[:, :8 * ntl] += a @ bt
                                c16 += 1
                                if c16 < cpt:
                                    addr0 = addr0 + 16
                                else:
                                    c16 = 0
                                    off = off + np.where(valid, ((ws - 2) if dj == 2 else 1) * ps, 0)
                                    dj = 0 if dj == 2 else dj + 1
                                    addr0 = abase + off
                            if ks == 1:
                                for j in range(ntl):
                                    for i in range(4):
                                        pr = mtile * 16 + g + 8 * (i // 2)
                                        o = (nt0 + j) * 8 + 2 * t4 + i % 2
                                        for pp, oo, v in zip(pr, o, acc[g + 8 * (i // 2), j * 8 + 2 * t4 + i % 2]):
                                            if pp < npx:
                                                store(pp, oo, epi(oo, v))
                            else:
                                red[item] = acc
                        if ks > 1:
                            for unit in range(mt * ng):
                                mtile, grp = divmod(unit, ng)
                                v = sum(red[unit * ks + k] for k in range(ks))
                                for row in range(16):
                                    for col in range(32):
                                        pp, o = mtile * 16 + row, grp * 32 + col
                                        if pp < npx and o < y["cop"]:
                                            store(pp, o, epi(o, v[row, col]))
                    assert not np.isnan(res).any()
                    res = res.reshape(i1 - i0, y["wo"], y["cop"])
                    if l == n - 1:
                        for i in range(i0, i1):
                            out[b, i] = res[i - i0, :, :y["co"]].astype(np.float32).reshape(-1)
                            writes[b, i] += 1
                    elif l == q["l1"] - 1:
                        acts.setdefault(l, np.full((b_n, y["ho"], y["wo"], y["cop"]), np.nan))
                        acts[l][b, i0:i1] = _r16(res)
                    else:
                        parts[(l, band)] = _r16(res)
    return out, writes


def _refenc_inputs(rng, b, t, f, channels):
    mel = rng.uniform(0, 1, (b, t, f)).astype(np.float32)
    kerns, scales, biases, c_in = [], [], [], 1
    for c in channels:
        kerns.append(rng.uniform(-0.5, 0.5, (3, 3, c_in, c)).astype(np.float32) / np.sqrt(c_in))
        scales.append(rng.uniform(0.5, 1.5, c).astype(np.float32))
        biases.append(rng.normal(0, 0.1, c).astype(np.float32))
        c_in = c
    return mel, kerns, scales, biases


@pytest.mark.parametrize("t,f,channels,lengths,max_smem", [
    (19, 16, (4, 8, 8), (19, 7), None),        # odd T, ragged lengths, C_in 4: channel padding
    (24, 12, (8, 12, 16), None, None),         # C_out 12: a padded n8 tile
    (37, 20, (16, 32, 32), (30, 37), None),    # clusters of 2: halo rows from the next CTA
    (37, 20, (16, 32, 32), (30, 37), 20000),   # too little shared memory: layer 0 alone
])
def test_refenc_bf16_emulation_matches_plain(monkeypatch, t, f, channels, lengths, max_smem):
    """The bf16 kernel's plan emulated launch by launch in float64 (see
    ``emulate_refenc_bf16``): every output written once, within float32
    rounding of ``refenc_stack_plain(bf16=True)`` (a value on a bf16
    rounding boundary may move one bf16 step between layers); with a small
    shared memory the plan peels the leading layers into launches of their
    own over bands of rows, and the result is the same."""
    if max_smem:
        monkeypatch.setattr(trefenc, "_MAX_SMEM", max_smem)
    plan = trefenc.bf16_plan(t, f, channels)
    if max_smem:
        assert len(plan["launches"]) > 1 and plan["launches"][0]["l1"] == 1
    if t == 37 and not max_smem:
        assert plan["launches"][0]["bands"] == 2
    rng = np.random.default_rng(t + f)
    mel, kerns, scales, biases = _refenc_inputs(rng, 2, t, f, channels)
    lens = None if lengths is None else np.array(lengths)
    got, writes = emulate_refenc_bf16(mel, lens, kerns, scales, biases, plan)
    assert (writes == 1).all()
    t32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    ref = trefenc.refenc_stack_plain(
        t32(mel), [t32(k) for k in kerns], [t32(v) for v in scales], [t32(v) for v in biases],
        lengths=None if lens is None else torch.from_numpy(lens), bf16=True).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2)
    assert np.abs(got - ref).mean() < 1e-4


@pytest.mark.parametrize("t,f", [(128, 80), (256, 80), (101, 80), (1, 80), (4096, 80),
                                 (8192, 80), (64, 513), (3, 1)])
def test_refenc_bf16_plan_takes_every_shape(t, f):
    """Every shape the mode took as one launch a layer still runs: the whole
    stack in one clustered launch where an utterance's bands fit (T up to
    256 at 80 bins), else its leading layers one launch each over bands of
    rows (no cluster); every launch within one block's shared memory, at
    most 8 CTAs a cluster, each layer in exactly one launch, at most 8 k
    part items a band."""
    channels = [32, 32, 64, 64, 128, 128]
    plan = trefenc.bf16_plan(t, f, channels)
    shapes = trefenc.stack_shapes(t, f, channels)
    covered = []
    for q in plan["launches"]:
        assert q["smem"] <= 232448
        covered += list(range(q["l0"], q["l1"]))
        if q["l1"] - q["l0"] > 1:
            assert q["bands"] in (1, 2, 4, 8)
        for l in range(q["l0"], q["l1"]):
            ho, bh = shapes[l]["ho"], plan["bh"][l]
            if q["l1"] - q["l0"] > 1:      # the cluster's CTAs split every layer's rows
                assert bh == -(-ho // q["bands"])
            else:                          # bands of up to 16 rows, no cluster
                assert q["bands"] == -(-ho // bh) and bh <= 16
    assert covered == list(range(len(channels)))
    for l, s in enumerate(shapes):
        units = -(-plan["bh"][l] * s["wo"] // 16) * -(-s["cop"] // 32)
        assert plan["ks"][l] == 1 or units * plan["ks"][l] <= 8
    if t <= 256 and f == 80:
        assert len(plan["launches"]) == 1
    if t == 4096:
        assert [(q["l0"], q["l1"]) for q in plan["launches"]] == [(0, 1), (1, 2), (2, 3), (3, 6)]
