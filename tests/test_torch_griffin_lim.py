"""Griffin-Lim's bf16 kernels without a card (``ops/griffin_lim.py``): the
plain loop of ``TorchDSP`` (the CPU's route and the kernels' oracle) keeps
its bits and counts ``griffin_lim_plain_iters``; the wrapper refuses CPU
tensors and configurations it does not take; the kernels' layouts (the
interleaved bases and operand) and index maps (G2's overlap-add and reflect
pad, G3's chunk rows) computed in plain PyTorch give the plain loop's
iteration; the ``gl_kernel_share.synth`` reader. The kernels themselves run
in tests/test_torch_card_griffin_lim.py on the card."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from gst_tacotron_tpu_torch.config import AudioConfig, get_preset, load_config
from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP, _dft_bases_np
from gst_tacotron_tpu_torch.ops import griffin_lim as gl
from gst_tacotron_tpu_torch.utils.profiling import counters

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
KW = dict(n_fft=512, hop_length=128, win_length=256, griffin_lim_iters=4,
          griffin_lim_momentum=0.99)


def spectrogram(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0.2, 0.9, shape)
                            .astype(np.float32))


def old_loop(dsp, magnitude):
    """``TorchDSP.griffin_lim`` from a zero phase as the port wrote it before
    its iterations moved into ``griffin_lim_iterations_plain``."""
    cfg = dsp.cfg
    re, im = magnitude, torch.zeros_like(magnitude)
    alpha, lp = cfg.griffin_lim_momentum, bool(cfg.griffin_lim_bf16)
    pre, pim = re, im
    for _ in range(cfg.griffin_lim_iters):
        cre = re + alpha * (re - pre)
        cim = im + alpha * (im - pim)
        re2, im2 = dsp.stft_ri(dsp.istft_ri(cre, cim, lp), lp)
        scale = magnitude / torch.clamp(torch.sqrt(re2 * re2 + im2 * im2), min=1e-16)
        re, im, pre, pim = re2 * scale, im2 * scale, re, im
    return dsp.istft_ri(re, im)


def deltas(before):
    now = counters()
    return tuple(now.get(k, 0) - before.get(k, 0)
                 for k in ("griffin_lim_plain_iters", "griffin_lim_kernel_iters"))


@pytest.mark.parametrize("bf16", [True, False])
def test_plain_loop_keeps_its_bits_and_counts(bf16):
    cfg = AudioConfig(**KW, griffin_lim_bf16=bf16)
    dsp = TorchDSP(cfg, "cpu")
    mag = spectrogram((2, 11, cfg.num_freq), seed=3)
    before = counters()
    wav = dsp.griffin_lim(mag)
    assert deltas(before) == (cfg.griffin_lim_iters, 0)
    np.testing.assert_array_equal(wav.numpy(), old_loop(dsp, mag).numpy())


def test_seeded_start_keeps_its_bits():
    cfg = AudioConfig(**KW)
    mag = spectrogram((2, 9, cfg.num_freq), seed=4)
    dsp = TorchDSP(cfg, "cpu")
    a = dsp.griffin_lim(mag, torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    ang = torch.rand(mag.shape, generator=g) * (2.0 * np.pi)
    re, im = dsp.griffin_lim_iterations_plain(mag, mag * torch.cos(ang), mag * torch.sin(ang))
    np.testing.assert_array_equal(a.numpy(), dsp.istft_ri(re, im).numpy())


def test_wrapper_refuses_cpu_tensors():
    cfg = AudioConfig(**KW)
    mag = spectrogram((1, 9, cfg.num_freq), seed=5)
    before = counters()
    with pytest.raises(ValueError, match="CUDA tensors"):
        gl.griffin_lim_iterations(TorchDSP(cfg, "cpu"), mag, mag, torch.zeros_like(mag))
    assert deltas(before) == (0, 0)


@pytest.mark.parametrize("kw,match", [({"griffin_lim_bf16": False}, "bf16 iterations"),
                                      ({"hop_length": 100, "n_fft": 400, "win_length": 400},
                                       "multiple of 64"),
                                      ({"hop_length": 32}, "multiple of 64")])
def test_wrapper_refuses_configurations_it_cannot_take(kw, match):
    cfg = AudioConfig(**{**KW, **kw})
    mag = spectrogram((1, 9, cfg.num_freq), seed=6)
    with pytest.raises(ValueError, match=match):
        gl.griffin_lim_iterations(TorchDSP(cfg, "cpu"), mag, mag, torch.zeros_like(mag))


@pytest.mark.parametrize("preset", ["gst_lj", "golden"])
def test_plan_and_bases_layout(preset):
    cfg = (load_config(str(REPO / "tests/fixtures/golden/config.json")).audio
           if preset == "golden" else get_preset(preset).audio)
    plan, nf = gl.gl_plan(cfg), cfg.num_freq
    fwd, inv = _dft_bases_np(cfg)
    inv_k, fwd_k = gl.kernel_bases_np(cfg)
    n_live = plan["n_live"]
    assert fwd.shape == (n_live, 2 * nf) and inv.shape == (2 * nf, n_live)
    assert inv_k.shape == (plan["inv_rows"], plan["k1"]) and plan["k1"] % 64 == 0
    assert fwd_k.shape == (plan["fwd_rows"], n_live) and plan["fwd_rows"] == 128 * plan["bin_tiles"]
    assert plan["inv_rows"] % 256 == 0 and plan["ldspec"] % 8 == 0
    np.testing.assert_array_equal(inv_k[:n_live, 0:2 * nf:2], inv[:nf].T)
    np.testing.assert_array_equal(inv_k[:n_live, 1:2 * nf:2], inv[nf:].T)
    np.testing.assert_array_equal(fwd_k[0:2 * nf:2], fwd[:, :nf].T)
    np.testing.assert_array_equal(fwd_k[1:2 * nf:2], fwd[:, nf:].T)
    assert not inv_k[n_live:].any() and not inv_k[:, 2 * nf:].any() and not fwd_k[2 * nf:].any()
    if preset == "gst_lj":
        assert plan == {"j0": 2, "nk": 4, "n_live": 1024, "k1": 2112, "ldspec": 2056,
                        "inv_rows": 1024, "fwd_rows": 2176, "bin_tiles": 17}


def test_spectrum_operand_interleaves():
    cfg = get_preset("gst_lj").audio
    re, im = spectrogram((2, 3, cfg.num_freq), 8), spectrogram((2, 3, cfg.num_freq), 9)
    spec = gl.spectrum_operand(torch.stack((re, im), -1), cfg)
    assert spec.shape == (128, 2056) and spec.dtype == torch.bfloat16
    flat = spec[:6].float()
    np.testing.assert_array_equal(flat[:, 0:2050:2].numpy(),
                                  re.reshape(6, -1).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(flat[:, 1:2050:2].numpy(),
                                  im.reshape(6, -1).to(torch.bfloat16).float().numpy())
    assert not spec[6:].float().any() and not spec[:, 2050:].float().any()


@pytest.mark.parametrize("preset", ["gst_lj", "golden"])
def test_tile_order_round_trip(preset):
    """G3's tile order: bin tile i, row b*T + t holds bins 64i .. 64i + 63 of
    row (b, t), zero past F; ``row_order`` restores the state's bits."""
    cfg = (load_config(str(REPO / "tests/fixtures/golden/config.json")).audio
           if preset == "golden" else get_preset(preset).audio)
    nf, tiles = cfg.num_freq, gl.gl_plan(cfg)["bin_tiles"]
    state = torch.randn(2, 5, nf, 2)
    mag = torch.rand(2, 5, nf)
    st, mt = gl.tile_order(state, cfg), gl.tile_order(mag, cfg)
    assert st.shape == (tiles, 10, 64, 2) and mt.shape == (tiles, 10, 64)
    assert st.is_contiguous() and mt.is_contiguous()
    assert torch.equal(mt[1, 7, 3], mag[1, 2, 67]) and torch.equal(st[0, 9, 63], state[1, 4, 63])
    assert not mt[-1, :, nf - 64 * (tiles - 1):].any()
    assert torch.equal(gl.row_order(st, 2, 5, nf), state)


@pytest.mark.parametrize("preset,b,t", [("gst_lj", 2, 15), ("gst_lj", 1, 9), ("golden", 3, 9)])
def test_emulated_iterations_follow_the_plain_loop(preset, b, t):
    """Two iterations through the kernels' layouts and index maps from a
    random-phase start: within 5e-3 of the peak of the plain loop's (float32
    sums in another order can move a wave sample across a bf16 rounding
    step, which momentum then carries)."""
    cfg = (load_config(str(REPO / "tests/fixtures/golden/config.json")).audio
           if preset == "golden" else get_preset(preset).audio)
    cfg = dataclasses.replace(cfg, griffin_lim_iters=2)
    dsp = TorchDSP(cfg, "cpu")
    mag = spectrogram((b, t, cfg.num_freq), seed=t) ** 1.5
    ang = torch.from_numpy(np.random.default_rng(b).uniform(0, 2 * np.pi, mag.shape)
                           .astype(np.float32))
    re0, im0 = mag * torch.cos(ang), mag * torch.sin(ang)
    state = torch.stack((re0, im0), -1)
    spec = gl.spectrum_operand(state, cfg)
    for _ in range(cfg.griffin_lim_iters):
        state, spec = gl.emulate_iteration(dsp, mag, state, spec)
    re, im = dsp.griffin_lim_iterations_plain(mag, re0, im0)
    peak = float(torch.stack((re, im)).abs().max())
    assert float((state[..., 0] - re).abs().max()) <= 5e-3 * peak
    assert float((state[..., 1] - im).abs().max()) <= 5e-3 * peak


def _reader():
    path = REPO / "benchmark" / "metrics" / "gl_kernel_share.synth.py"
    spec = importlib.util.spec_from_file_location("gl_kernel_share_synth", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("counted,want", [
    ({"griffin_lim_kernel_iters": 300, "calls": 10}, 100.0),
    ({"griffin_lim_kernel_iters": 90, "griffin_lim_plain_iters": 30}, 75.0),
    ({"griffin_lim_plain_iters": 30}, 0.0),
    ({"calls": 10, "d2h_bytes": 5}, None),
    ({}, None)])
def test_gl_kernel_share_reader(counted, want):
    read = _reader()
    assert read({"counters": counted}) == want
    assert read({}) is None
