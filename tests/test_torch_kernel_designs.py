"""The CUDA designs of K3, K3′ and K3″ (mel-STFT as a shared-memory FFT,
K3′'s bf16 bases on tensor cores) and K1 (GRU scan on thread-block
clusters), checked on the CPU without a card:

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
- K3′'s bf16 tile: the ldmatrix and ``mma.sync.m16n8k16`` fragment index
  maps over ``mma_b_fragments`` against a plain product, and its cluster
  width by n_fft;
- K2's layer kernels: ``layer_plan``'s grids at the main shape, and a numpy
  emulation of a layer's tiles (pixel slots, k parts, SAME padding, the
  length mask) against the plain stack.
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
# K3′ bf16: the tensor-core tile's fragment maps
# ---------------------------------------------------------------------------


def _bf16_values(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16) \
        .to(torch.float32).numpy()


def _pair(reg):
    """The two bf16 halves of int32 registers as float32 (low half first)."""
    u = np.asarray(reg).astype(np.int64) & 0xFFFFFFFF
    lo = ((u & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    hi = (u & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return lo, hi


@pytest.mark.parametrize("n_live,nfp", [(1024, 1152), (100, 256), (1500, 128)])
def test_bf16_tile_fragment_maps(n_live, nfp):
    """The kernel's tile, lane by lane: A from the staged taps through
    ldmatrix.x4 (lane l addresses row l % 16, column block l / 16), B from
    ``mma_b_fragments``, each m16n8k16 product per the PTX fragment layouts,
    C scattered to (row g + 8*(i/2), bin nt*8 + 2*t + i%2). The
    sum over the k16 steps equals the plain product of the bf16-rounded
    operands (float64 sums here, so exactly)."""
    rng = np.random.default_rng(n_live)
    tf, mt = 16, 1                                   # BF_TF: one m16 row tile
    a = rng.uniform(-1, 1, (tf, n_live)).astype(np.float32)
    b = rng.uniform(-1, 1, (n_live, nfp)).astype(np.float32)
    frag = tstft.mma_b_fragments(b)
    ks_n = -(-n_live // 16)
    assert frag.shape == (nfp // 8, ks_n, 32, 2) and frag.dtype == np.int32
    ka, kas = 1024, 1024 + 8                         # BF_KA taps resident, row stride BF_KAS
    staged = np.zeros((tf, ks_n * 16 + ka), np.float32)
    staged[:, :n_live] = _bf16_values(a)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = np.zeros((tf, nfp))
    for ks in range(ks_n):
        c, kk = divmod(ks, ka // 16)                 # resident chunk, its k16 step
        smem = np.zeros((tf, kas), np.float32)
        smem[:, :ka] = staged[:, c * ka:(c + 1) * ka]
        flat = smem.reshape(-1)
        for m in range(mt):
            # ldmatrix.x4: matrix j's row r is at the address lane 8j + r gives
            addr = (m * 16 + (lane & 15)) * kas + kk * 16 + (lane >> 4) * 8
            regs = [(flat[addr[8 * j + g] + 2 * t], flat[addr[8 * j + g] + 2 * t + 1])
                    for j in range(4)]
            # PTX A layout: reg0 (g, 2t..), reg1 (g+8, 2t..), reg2 (g, 2t+8..), reg3 (g+8, 2t+8..)
            atile = np.zeros((16, 16))
            for j, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
                atile[g + dr, 2 * t + dc], atile[g + dr, 2 * t + dc + 1] = regs[j]
            np.testing.assert_array_equal(atile, staged[m * 16:(m + 1) * 16, ks * 16:ks * 16 + 16])
            for nt in range(nfp // 8):
                b0 = _pair(frag[nt, ks, :, 0])
                b1 = _pair(frag[nt, ks, :, 1])
                btile = np.zeros((16, 8))
                btile[2 * t, g], btile[2 * t + 1, g] = b0
                btile[2 * t + 8, g], btile[2 * t + 9, g] = b1
                ctile = atile @ btile
                for i in range(4):              # C layout: (g + 8*(i//2), 2t + i%2)
                    out[m * 16 + g + 8 * (i // 2), nt * 8 + 2 * t + i % 2] += \
                        ctile[g + 8 * (i // 2), 2 * t + i % 2]
    want = _bf16_values(a).astype(np.float64) @ _bf16_values(b).astype(np.float64)
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)


def test_bf16_launch_plan():
    """16-frame tiles over clusters of 2 CTAs, each half of the 128-bin
    windows, while the CTA's shared memory fits (up to n_fft 4863, 19
    windows); then 4 and 8 CTAs, each holding fewer windows (n_fft 4864,
    8192 and 19711, which a cluster of 2 once refused, now run); past 19711,
    ValueError naming the size. The fragment tables are not among
    ``stft_bases``: the first bf16 call builds them."""
    assert (tstft.BF16_TILE, tstft.BF16_CLUSTERS) == (16, (2, 4, 8))
    for n_fft in (400, 1024, 1536, 1575, 2048, 4096, 4863):
        assert tstft.bf16_cluster(n_fft) == 2
        assert tstft.bf16_smem(n_fft) <= 232448
    assert tstft.bf16_smem(2048) == 146176             # 9 windows
    for n_fft, cw in ((4864, 4), (6144, 4), (8192, 4), (9727, 4), (9728, 8), (19711, 8)):
        assert tstft.bf16_cluster(n_fft) == cw
        assert tstft.bf16_smem(n_fft, cw) <= 232448 < tstft.bf16_smem(n_fft, cw // 2)
    with pytest.raises(ValueError, match="n_fft 19712"):
        tstft.bf16_cluster(19712)
    cfg = AudioConfig(n_fft=512, hop_length=128, win_length=512)
    assert not any(k.startswith("bf16") for k in tstft.stft_bases(cfg, "cpu"))
    bcos, bsin = tstft._bf16_fragments(cfg, "cpu")
    cos_b, sin_b, _ = tstft._bases_np(cfg)
    np.testing.assert_array_equal(bcos.numpy(), tstft.mma_b_fragments(cos_b))
    np.testing.assert_array_equal(bsin.numpy(), tstft.mma_b_fragments(sin_b))


def test_bf16_fragments_use_torchs_rounding():
    """The host rounds the bases as ``round_bf16`` (torch's cast, ties to even)."""
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -2.5e-3, 3e38, 0.0], np.float32)
    bits = tstft.bf16_bits(x)
    back = (bits.astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(back, tstft.round_bf16(torch.from_numpy(x)).numpy())


# ---------------------------------------------------------------------------
# K2: one launch a layer
# ---------------------------------------------------------------------------


def test_refenc_layer_plan_spreads_each_layer():
    """At the main shape every layer gives the 132 SMs two blocks each; the
    late layers split their input-channel sums (ks) to get there."""
    plan = trefenc.layer_plan(32, 128, 80, [32, 32, 64, 64, 128, 128], 132)
    assert [p["blocks"] for p in plan] == [2560, 640, 320, 320, 384, 512]
    assert [(p["ks"], p["px"]) for p in plan] == [(1, 4), (1, 4), (1, 4), (2, 2), (2, 1),
                                                   (8, 1)]
    assert [p["shape"] for p in plan][-1] == (2, 2, 128)
    small = trefenc.layer_plan(1, 19, 16, [4, 4, 8], 132)
    c_in = [1, 4, 4]
    for p, c in zip(small, c_in):
        assert trefenc.GROUPS % p["ks"] == 0 and p["ks"] <= c and p["px"] in (1, 2, 4)


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
