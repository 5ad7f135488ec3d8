"""Griffin-Lim's shape-only tables in ``TorchDSP``: the window-square norm of
``istft_ri`` (by frame count) and the three tables of ``inv_preemphasis``
(by padded block count) are built once per length, kept on the device in a
bounded LRU, and counted as ``dsp_table_builds`` and ``dsp_table_hits``.

Every table, and every waveform made with them, is held bit for bit to
``RebuildingDSP``: the same class with the tables built afresh at every use,
as the port built them before they were cached. No JAX here: the CUDA case
runs on the card with ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gl_tables.py -q
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gst_tacotron_tpu_torch.config import AudioConfig, load_config
from gst_tacotron_tpu_torch.dsp import torch_dsp
from gst_tacotron_tpu_torch.dsp.torch_dsp import IIR_BLOCK, TABLE_LENGTHS, TorchDSP
from gst_tacotron_tpu_torch.utils.profiling import counters

torch.set_num_threads(2)

KW = dict(n_fft=512, hop_length=128, win_length=256, griffin_lim_iters=30,
          griffin_lim_momentum=0.99, griffin_lim_bf16=False)
FRAMES = (1, 2, 7, 8, 1000)
REPO = Path(__file__).resolve().parent.parent


class RebuildingDSP(TorchDSP):
    """``TorchDSP`` with every shape-only table built on the host and copied
    to the device at each use, by the loop and ``np.power`` tables of the
    uncached code."""

    def _win_norm(self, num_frames):
        cfg = self.cfg
        total = cfg.n_fft + cfg.hop_length * (num_frames - 1)
        norm = np.zeros(total, np.float64)
        for t in range(num_frames):
            norm[t * cfg.hop_length: t * cfg.hop_length + cfg.n_fft] += self._winsq
        return torch.from_numpy(np.maximum(norm, 1e-10).astype(np.float32)).to(self.device)

    def inv_preemphasis(self, wav):
        coef = self.cfg.preemphasis
        if coef == 0.0:
            return wav
        b, n = wav.shape
        blk = IIR_BLOCK
        nb = -(-n // blk)
        x = F.pad(wav, (0, nb * blk - n)).reshape(b, nb, blk)
        i = np.arange(blk)
        tri = np.where(i[:, None] >= i[None, :],
                       np.power(coef, np.maximum(i[:, None] - i[None, :], 0)), 0.0)
        y = x @ torch.from_numpy(tri.T.astype(np.float32)).to(wav.device)
        m = np.arange(nb)
        with np.errstate(under="ignore"):
            tri2 = np.where(m[:, None] >= m[None, :],
                            np.power(coef ** blk, np.maximum(m[:, None] - m[None, :], 0)), 0.0)
        last = y[:, :, -1] @ torch.from_numpy(tri2.T.astype(np.float32)).to(wav.device)
        carry = F.pad(last, (1, 0))[:, :-1]
        decay = torch.from_numpy(np.power(coef, i + 1).astype(np.float32)).to(wav.device)
        y = y + carry[:, :, None] * decay
        return y.reshape(b, nb * blk)[:, :n]


def deltas(before):
    now = counters()
    return (now.get("dsp_table_builds", 0) - before.get("dsp_table_builds", 0),
            now.get("dsp_table_hits", 0) - before.get("dsp_table_hits", 0))


def spectrogram(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0.2, 0.9, shape)
                            .astype(np.float32))


@pytest.mark.parametrize("frames", FRAMES)
def test_cached_tables_equal_a_fresh_build(frames):
    """The cached norm and ``inv_preemphasis`` on the cached tables equal the
    uncached code's bit for bit, on the first use and on a cached one, at
    lengths that fill no whole block (hop * (frames - 1) samples) and at
    exact multiples of the block."""
    td, ref = TorchDSP(AudioConfig(**KW), "cpu"), RebuildingDSP(AudioConfig(**KW), "cpu")
    for _ in range(2):
        np.testing.assert_array_equal(td._win_norm(frames).numpy(),
                                      ref._win_norm(frames).numpy())
    rng = np.random.default_rng(frames)
    for n in (KW["hop_length"] * (frames - 1), IIR_BLOCK * max(frames // 4, 1)):
        wav = torch.from_numpy(rng.uniform(-1, 1, (2, n)).astype(np.float32))
        for _ in range(2):
            np.testing.assert_array_equal(td.inv_preemphasis(wav).numpy(),
                                          ref.inv_preemphasis(wav).numpy())


@pytest.mark.parametrize("frames", FRAMES)
def test_iir_tables_are_the_uncached_tables(frames):
    """The three tables of ``inv_preemphasis`` as cached: the in-block and
    carry triangles (transposed) and the decay, as the uncached code built
    them (float64 ``np.power``, one float32 cast)."""
    td = TorchDSP(AudioConfig(**KW), "cpu")
    coef, blk = td.cfg.preemphasis, IIR_BLOCK
    nb = -(-KW["hop_length"] * (frames - 1) // blk)
    tri, tri2, decay = td._cached_tables("iir", nb, td.device, td._iir_tables_np)
    i, m = np.arange(blk), np.arange(nb)
    want_tri = np.where(i[:, None] >= i[None, :],
                        np.power(coef, np.maximum(i[:, None] - i[None, :], 0)), 0.0)
    with np.errstate(under="ignore"):
        want_tri2 = np.where(m[:, None] >= m[None, :],
                             np.power(coef ** blk, np.maximum(m[:, None] - m[None, :], 0)), 0.0)
    np.testing.assert_array_equal(tri.numpy(), want_tri.T.astype(np.float32))
    np.testing.assert_array_equal(tri2.numpy(), want_tri2.T.astype(np.float32))
    np.testing.assert_array_equal(decay.numpy(), np.power(coef, i + 1).astype(np.float32))


@pytest.mark.parametrize("bf16", [False, True])
def test_inv_linear_spectrogram_repeats_its_bits(bf16):
    """The waveform of a first call (tables built), a second call (tables
    cached), a new ``TorchDSP`` and the uncached code are one array."""
    cfg = AudioConfig(**{**KW, "griffin_lim_iters": 4, "griffin_lim_bf16": bf16})
    spect = spectrogram((2, 11, cfg.n_fft // 2 + 1), seed=5)
    td = TorchDSP(cfg, "cpu")
    first = td.inv_linear_spectrogram(spect).numpy()
    np.testing.assert_array_equal(td.inv_linear_spectrogram(spect).numpy(), first)
    np.testing.assert_array_equal(TorchDSP(cfg, "cpu").inv_linear_spectrogram(spect).numpy(),
                                  first)
    np.testing.assert_array_equal(RebuildingDSP(cfg, "cpu").inv_linear_spectrogram(spect).numpy(),
                                  first)


def test_counters_count_builds_then_hits():
    """A new length builds each of its four tables once (one norm, three
    preemphasis tables); every later use is a hit: 30 iterations and the
    last inverse read the norm 31 times a call, and the preemphasis takes
    its three tables."""
    cfg = AudioConfig(**KW)
    td = TorchDSP(cfg, "cpu")
    spect = spectrogram((2, 8, cfg.n_fft // 2 + 1), seed=6)
    before = counters()
    td.inv_linear_spectrogram(spect)
    assert deltas(before) == (4, 30)
    before = counters()
    td.inv_linear_spectrogram(spect)
    assert deltas(before) == (0, 31 + 3)
    before = counters()
    td.inv_linear_spectrogram(spectrogram((2, 9, cfg.n_fft // 2 + 1), seed=7))
    assert deltas(before) == (1, 30 + 3), "9 frames: a new norm, the same block count"


def test_lru_evicts_past_its_bound_and_rebuilds_the_same_bits():
    td, ref = TorchDSP(AudioConfig(**KW), "cpu"), RebuildingDSP(AudioConfig(**KW), "cpu")
    lengths = range(3, 3 + TABLE_LENGTHS + 1)
    first = td._win_norm(lengths[0])
    before = counters()
    for t in lengths[1:]:
        td._win_norm(t)
        td._cached_tables("iir", t, td.device, td._iir_tables_np)
    assert deltas(before) == (4 * TABLE_LENGTHS, 0)
    assert [len(lru) for lru in td._tables.values()] == [TABLE_LENGTHS, TABLE_LENGTHS]
    before = counters()
    again = td._win_norm(lengths[0])
    assert deltas(before) == (1, 0), "the least recently used length was evicted"
    assert again is not first
    np.testing.assert_array_equal(again.numpy(), ref._win_norm(lengths[0]).numpy())
    before = counters()
    td._win_norm(lengths[-1])
    assert deltas(before) == (0, 1), "the most recently used length stays"


def test_no_preemphasis_builds_no_table():
    td = TorchDSP(AudioConfig(**{**KW, "preemphasis": 0.0}), "cpu")
    wav = torch.ones(1, 300)
    before = counters()
    assert td.inv_preemphasis(wav) is wav
    assert deltas(before) == (0, 0)


def test_live_span_is_the_tap_span():
    cfg = AudioConfig(**KW)
    j0, _, n_live = torch_dsp.live_tap_span(cfg)
    assert TorchDSP(cfg, "cpu")._live_span == (j0 * cfg.hop_length, n_live)


@pytest.mark.cuda
def test_cached_call_repeats_its_bits_on_the_card():
    """``gst_lj``'s Griffin-Lim (30 bf16 iterations, momentum 0.99) of a
    seeded (4, 200, 1025) spectrogram on the card: the cached call, a new
    ``TorchDSP`` and the uncached code give the first call's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: Griffin-Lim's bf16 GEMMs run there")
    audio = load_config(str(REPO / "configs/gst_lj.json")).audio
    assert audio.griffin_lim_bf16 and audio.griffin_lim_iters == 30
    dev = torch.device("cuda", 0)
    spect = spectrogram((4, 200, audio.n_fft // 2 + 1), seed=23).to(dev)
    td = TorchDSP(audio, dev)
    first = td.inv_linear_spectrogram(spect).cpu().numpy()
    before = counters()
    cached = td.inv_linear_spectrogram(spect).cpu().numpy()
    assert deltas(before) == (0, 31 + 3)
    np.testing.assert_array_equal(cached, first)
    for other in (TorchDSP(audio, dev), RebuildingDSP(audio, dev)):
        np.testing.assert_array_equal(other.inv_linear_spectrogram(spect).cpu().numpy(), first)
    off = TorchDSP(dataclasses.replace(audio, griffin_lim_bf16=False), dev)
    np.testing.assert_array_equal(off.inv_linear_spectrogram(spect).cpu().numpy(),
                                  off.inv_linear_spectrogram(spect).cpu().numpy())
