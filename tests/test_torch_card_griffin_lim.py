"""Griffin-Lim's bf16 iterations on the card (``ops/griffin_lim.py``,
``csrc/griffin_lim.cu``) against the plain loop on the CPU copies of the same
inputs:

* one iteration at the synthesis cells' shape (B = 32 rows of 1000 frames,
  gst_lj's audio): re and im within 5e-3 of the peak
  (tests/test_torch_dsp.py's bf16 bound over three iterations);
* 30 iterations of harmonic signals (tests/test_dsp.py's ``make_wav``): the
  spectral error within 5% of the plain loop's;
* ragged shapes (B = 1, T = 15; T off the 128-frame tile), gst_lj's audio
  and the golden fixture's (n_fft 512, every chunk live), one iteration;
* the seeded random-phase start;
* the same bits twice;
* ``Synthesizer`` on gst_lj through the kernel: 30 launches and 30
  ``griffin_lim_kernel_iters`` a call, no plain iteration.

Needs an NVIDIA GPU and nvcc; skipped without a card. Imports no JAX, so it
runs on the GPU machine with ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card_griffin_lim.py -q
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

# by its own name, from tests/ on the path: where JAX is absent, an
# installed package may own the name ``tests``
from test_torch_cuda import dev  # noqa: F401 (the card fixture)

pytestmark = pytest.mark.cuda

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
GL_TOL = 5e-3


def audio_of(name, **kw):
    from gst_tacotron_tpu_torch.config import get_preset, load_config

    cfg = (load_config(os.path.join(FIXTURES, "golden", "config.json")) if name == "golden"
           else get_preset(name))
    return dataclasses.replace(cfg.audio, **kw)


def magnitudes(audio, b, t, seed):
    """(b, t, F) magnitudes of harmonic signals with a little noise, to
    Griffin-Lim's power (float32 STFT on the CPU)."""
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP

    rng = np.random.default_rng(seed)
    n = audio.hop_length * (t - 1)
    x = np.arange(n) / audio.sample_rate
    wavs = []
    for _ in range(b):
        f0 = rng.uniform(90, 250)
        w = sum(0.5 ** k * np.sin(2 * np.pi * (k + 1) * f0 * x + rng.uniform(0, 6.3))
                for k in range(4))
        wavs.append(0.3 * w + rng.normal(0, 0.01, n))
    wav = torch.from_numpy(np.stack(wavs).astype(np.float32))
    return TorchDSP(audio, "cpu").magnitude(wav) ** audio.griffin_lim_power


def iterate(audio, mag, re, im, dev):
    """(kernel (re, im) on the card, plain (re, im) on the CPU) from one start."""
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP
    from gst_tacotron_tpu_torch.ops.griffin_lim import griffin_lim_iterations

    with torch.no_grad():
        got = griffin_lim_iterations(TorchDSP(audio, dev), mag.to(dev), re.to(dev), im.to(dev))
        torch.cuda.synchronize()
        want = TorchDSP(audio, "cpu").griffin_lim_iterations_plain(mag, re, im)
    return tuple(x.cpu() for x in got), want


def rel_err(got, want):
    peak = max(float(x.abs().max()) for x in want)
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / peak


def l2_err(got, want):
    return float(torch.linalg.norm(torch.stack(got) - torch.stack(want))
                 / torch.linalg.norm(torch.stack(want)))


def test_one_iteration_at_the_cells_shape(dev):
    """Against the plain loop on the CPU, beside the torch loop the kernels
    replaced (the same bf16 products, one cuBLAS GEMM each, on the card). A
    float32 sum in another order now and then moves a wave sample across a
    bf16 rounding step, and the projection carries that to the bin's
    magnitude, so the largest difference is a heavy tail: over 32.8 M bins
    the torch loop's reads 7.2e-3 of the peak, past tests/test_torch_dsp.py's
    5e-3 (set over 3.9 k bins), and its L2 difference 9.5e-5. So the
    kernels' L2 difference within twice the larger of 1e-4 and the torch
    loop's, and their largest within twice the larger of 5e-3 and the torch
    loop's."""
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP

    audio = audio_of("gst_lj", griffin_lim_iters=1)
    assert audio.griffin_lim_bf16 and audio.n_fft == 2048 and audio.hop_length == 256
    mag = magnitudes(audio, 32, 1000, seed=1)
    z = torch.zeros_like(mag)
    got, want = iterate(audio, mag, mag, z, dev)
    with torch.no_grad():
        magd = mag.to(dev)
        lib = tuple(x.cpu() for x in TorchDSP(audio, dev).griffin_lim_iterations_plain(
            magd, magd, torch.zeros_like(magd)))
    err, lib_err = rel_err(got, want), rel_err(lib, want)
    l2, lib_l2 = l2_err(got, want), l2_err(lib, want)
    print(f"one iteration, B=32 T=1000, of the peak: kernels {err:.3e}, torch loop "
          f"{lib_err:.3e}; L2 kernels {l2:.3e}, torch loop {lib_l2:.3e}")
    assert l2 <= 2 * max(1e-4, lib_l2)
    assert err <= 2 * max(GL_TOL, lib_err)


@pytest.mark.parametrize("seed", [7, 101])
def test_thirty_iterations_fit_as_well_as_the_plain_loop(dev, seed):
    """tests/test_dsp.py's signals (220 and 440 Hz, a little noise), 65,536
    samples; the spectral error of each waveform's float32 magnitude
    against the target within 5% of the plain loop's and below 0.25."""
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP

    audio = audio_of("gst_lj")
    rng = np.random.default_rng(seed)
    x = np.arange(65536) / 22050
    wav = 0.5 * np.sin(2 * np.pi * 220 * x) + 0.3 * np.sin(2 * np.pi * 440 * x)
    wav = (wav + 0.05 * rng.standard_normal(x.size)).astype(np.float32)
    dspf = TorchDSP(dataclasses.replace(audio, griffin_lim_bf16=False), "cpu")
    mag = dspf.magnitude(torch.from_numpy(wav[None]))
    with torch.no_grad():
        kernel = TorchDSP(audio, dev).griffin_lim(mag.to(dev)).cpu()
    plain = TorchDSP(audio, "cpu").griffin_lim(mag)

    def err(w):
        return float(torch.linalg.norm(mag - dspf.magnitude(w)) / torch.linalg.norm(mag))

    e_k, e_p = err(kernel), err(plain)
    print(f"seed {seed}: spectral error kernel {e_k:.4f}, plain {e_p:.4f}")
    assert e_k < e_p * 1.05 and e_k < 0.25


@pytest.mark.parametrize("name,b,t", [("gst_lj", 1, 15), ("gst_lj", 3, 201),
                                      ("gst_lj", 2, 129), ("golden", 3, 9)])
def test_ragged_shapes_one_iteration(dev, name, b, t):
    """One iteration, where a fault of a tile's edge would show whole (later
    iterations let float32 sums in another order grow through momentum: the
    plain loop against itself summed in another order reads 9e-3 of the
    peak after three at B = 1, T = 15)."""
    audio = audio_of(name, griffin_lim_iters=1)
    mag = magnitudes(audio, b, t, seed=t)
    got, want = iterate(audio, mag, mag, torch.zeros_like(mag), dev)
    assert got[0].shape == (b, t, audio.num_freq)
    err = rel_err(got, want)
    print(f"{name} B={b} T={t}, one iteration: {err:.3e} of the peak")
    assert err <= GL_TOL


def test_seeded_random_phase_start(dev):
    """The start of ``TorchDSP.griffin_lim``'s generator on the card, the
    same start handed to the plain loop; the seeded waveform repeats and
    differs from the zero-phase one."""
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP

    audio = audio_of("gst_lj", griffin_lim_iters=1)
    mag = magnitudes(audio, 2, 40, seed=3)
    g = torch.Generator(device=dev).manual_seed(1234)
    ang = torch.rand(mag.shape, generator=g, device=dev) * (2.0 * np.pi)
    magd = mag.to(dev)
    re, im = (magd * torch.cos(ang)).cpu(), (magd * torch.sin(ang)).cpu()
    got, want = iterate(audio, mag, re, im, dev)
    assert rel_err(got, want) <= GL_TOL
    dsp = TorchDSP(audio, dev)
    with torch.no_grad():
        seeded = [dsp.griffin_lim(magd, torch.Generator(device=dev).manual_seed(1234))
                  for _ in range(2)]
        zero = dsp.griffin_lim(magd)
    assert torch.equal(seeded[0], seeded[1])
    assert not torch.equal(seeded[0], zero)


def test_same_bits_twice(dev):
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP

    audio = audio_of("gst_lj")
    mag = magnitudes(audio, 4, 300, seed=5).to(dev)
    dsp = TorchDSP(audio, dev)
    with torch.no_grad():
        first = dsp.griffin_lim(mag)
        again = TorchDSP(audio, dev).griffin_lim(mag)
    assert torch.isfinite(first).all()
    assert torch.equal(first, again)


def test_synthesis_runs_the_kernel(dev):
    """gst_lj's ``Synthesizer`` (decode cut to 16 steps): one kernel launch and
    one ``griffin_lim_kernel_iters`` an iteration, 30 a call, and no plain
    iteration."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
    from gst_tacotron_tpu_torch.synthesize import Synthesizer
    from gst_tacotron_tpu_torch.utils.profiling import counters
    from gst_tacotron_tpu_torch.weights import build_model

    cfg = apply_overrides(get_preset("gst_lj"), {"model.decoder.stop_threshold": 1.0,
                                                 "model.decoder.max_decode_steps": 16})
    synth = Synthesizer(cfg, build_model(cfg, seed=0, device=dev), device=dev)
    texts = ["a short text for the vocoder.", "and another one, a little longer."]
    synth(texts, token_weights=np.full((2, cfg.model.gst.num_tokens), 0.1, np.float32))
    before = counters()
    ops.reset_launch_counts()
    out = synth(texts, token_weights=np.full((2, cfg.model.gst.num_tokens), 0.1, np.float32))
    torch.cuda.synchronize()
    now = counters()
    assert ops.launch_counts()["griffin_lim"] == 30
    assert now.get("griffin_lim_kernel_iters", 0) - before.get("griffin_lim_kernel_iters", 0) == 30
    assert now.get("griffin_lim_plain_iters", 0) == before.get("griffin_lim_plain_iters", 0)
    assert np.all(np.isfinite(out["wav"])) and np.abs(out["wav"]).max() <= 1.0
