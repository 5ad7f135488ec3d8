"""The CUDA designs of K3 (mel-STFT as a shared-memory FFT) and K1 (GRU scan
on thread-block clusters), checked on the CPU without a card:

- a numpy emulation of K3's FFT schedule (``csrc/fft.cuh``: the same
  twiddle table, Stockham index maps, first stage formed from the live taps,
  real split step) against ``np.fft.rfft`` of the windowed frame in float64,
  to 1e-6 of the frame's largest bin (float32 arithmetic, as on the card);
- K3's host tables: float64 twiddles rounded once, the live window taps,
  and the sparse mel, which rebuilds the dense basis exactly and whose
  ascending sum gives the dense loop's bits;
- K3's n_fft check and K1's launch plan for every GRU of every config and of
  the golden fixtures, and the shapes each refuses.
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


def emulate_k3_fft(live: np.ndarray, window: np.ndarray, n_fft: int,
                   twiddle: np.ndarray) -> np.ndarray:
    """K3's bins of (F, n_live) live-tap frames, in float32 as the kernel
    computes them: z[m] = x[2m] + i x[2m+1] of the windowed, rotated taps,
    radix-4 Stockham stages (one radix-2 last when log2 n is odd), split."""
    n = n_fft // 2
    x = np.zeros((live.shape[0], n_fft), np.float32)
    x[:, :live.shape[1]] = live * window
    z = (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64)

    def stage4(x, p, tw):
        q = n >> 2
        i = np.arange(q)
        k = i & (p - 1)
        u0, u1, u2, u3 = (x[:, i + j * q] for j in range(4))
        if p > 1:
            u1, u2, u3 = u1 * tw[k], u2 * tw[p + k], u3 * tw[2 * p + k]
        v0, v1, v2, d = u0 + u2, u0 - u2, u1 + u3, u1 - u3
        v3 = (d.imag - 1j * d.real).astype(np.complex64)          # -i (u1 - u3)
        j = ((i - k) << 2) + k
        y = np.empty_like(x)
        y[:, j], y[:, j + p], y[:, j + 2 * p], y[:, j + 3 * p] = (
            v0 + v2, v1 + v3, v0 - v2, v1 - v3)
        return y

    def stage2(x, p, tw):
        q = n >> 1
        i = np.arange(q)
        k = i & (p - 1)
        u0, u1 = x[:, i], x[:, i + q] * tw[k]
        j = ((i - k) << 1) + k
        y = np.empty_like(x)
        y[:, j], y[:, j + p] = u0 + u1, u0 - u1
        return y

    z = stage4(z, 1, twiddle)
    tw, p = twiddle[3:], 4
    while 4 * p <= n:
        z = stage4(z, p, tw)
        tw, p = tw[3 * p:], p * 4
    if p < n:
        z = stage2(z, p, tw)
    split = twiddle[n - 1:]
    k = np.arange(n + 1)
    a, c = z[:, k & (n - 1)], z[:, (n - k) & (n - 1)]
    ev = (0.5 * (a.real + c.real) + 0.5j * (a.imag - c.imag)).astype(np.complex64)
    od = (0.5 * (a.imag + c.imag) - 0.5j * (a.real - c.real)).astype(np.complex64)
    return ev + split[k] * od


@pytest.mark.parametrize("kw", FFT_CONFIGS, ids=lambda kw: f"{kw['n_fft']}-{kw['win_length']}")
def test_fft_schedule_emulation_matches_rfft(kw):
    cfg = AudioConfig(**kw)
    j0, _, n_live = tstft.live_tap_span(cfg)
    n0 = j0 * cfg.hop_length
    tables = tstft.stft_bases(cfg, "cpu")
    rng = np.random.default_rng(kw["n_fft"] + kw["win_length"])
    frames = rng.uniform(-1, 1, (8, cfg.n_fft)).astype(np.float32)
    got = emulate_k3_fft(frames[:, n0:n0 + n_live], tables["fft_window"].numpy(), cfg.n_fft,
                         _c64(tables["fft_twiddle"].numpy()))
    ref = np.fft.rfft(frames.astype(np.float64) * padded_window(cfg.win_length, cfg.n_fft),
                      axis=-1)
    # the taps were rotated by n0 to the start of the frame: a phase per bin
    unrotated = got * np.exp(-2j * np.pi * n0 * np.arange(cfg.num_freq) / cfg.n_fft)
    scale = np.abs(ref).max()
    assert np.abs(unrotated - ref).max() <= 1e-6 * scale
    assert np.abs(np.abs(got) - np.abs(ref)).max() <= 1e-6 * scale


@pytest.mark.parametrize("n_fft", [8, 16, 512, 1024, 2048, 4096])
def test_fft_twiddle_table(n_fft):
    """n_fft entries: the stages' exp(-2 pi i k q / (R p)), q-major, then the
    split twiddles; each is its float64 value rounded once to float32."""
    n = n_fft // 2
    want, p = [], 1
    while 4 * p <= n:
        want += [np.exp(-2j * np.pi * k * q / (4 * p)) for q in (1, 2, 3) for k in range(p)]
        p *= 4
    if p < n:
        want += [np.exp(-1j * np.pi * k / p) for k in range(p)]
    assert len(want) == n - 1
    want += [np.exp(-2j * np.pi * k / n_fft) for k in range(n + 1)]
    tw = tstft.fft_twiddles(n_fft)
    assert tw.shape == (n_fft,)
    np.testing.assert_allclose(tw, np.array(want), rtol=0, atol=1e-15)
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
    assert 0 < smem <= 232448


@pytest.mark.parametrize("n_fft,hop,win", [(1536, 256, 1024), (1000, 250, 1000),
                                           (4, 1, 4), (8192, 256, 8192)])
def test_fft_size_check_names_the_fused_route(n_fft, hop, win):
    with pytest.raises(ValueError, match='"fused"'):
        tstft.check_fft_size(AudioConfig(n_fft=n_fft, hop_length=hop, win_length=win))


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
    assert 1 <= plan["cluster"] <= 8 and plan["cluster"] * plan["units"] >= h
    assert plan["units"] == -(-h // plan["cluster"])
    s = plan["slices"]
    assert s & (s - 1) == 0 and 4 <= s <= 16 and s * tgru.SLICE_LEN >= h
    assert plan["threads"] % 32 == 0 and plan["units"] * s <= plan["threads"] <= 256
    assert plan["rows"] == tgru.ROWS and plan["clusters"] * plan["rows"] >= b
    assert plan["clusters"] == -(-b // plan["rows"])
    assert plan["smem"] == 4 * 2 * plan["rows"] * s * tgru.SLICE_LEN + 16


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
    with pytest.raises(ValueError, match="gru_scan"):
        tgru.launch_plan(b, h)
