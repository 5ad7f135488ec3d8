"""gst_tacotron_tpu_torch — the PyTorch and CUDA port of ``gst_tacotron_tpu``.

The JAX package beside it is the reference. This package imports ``torch``
and numpy, never ``jax`` and nothing of ``gst_tacotron_tpu``. It mirrors the
JAX layout so each counterpart is easy to find:

  config.py, text/   — copies of the JAX package's pure-Python config and text
  models/            — ``nn.Module`` counterparts of the flax modules
  dsp/               — mel filterbank, host numpy DSP (the oracle), PyTorch DSP,
                       feature extractor
  data/              — pattern generation and the bucketed loader (numpy, scipy)
  ops/               — one wrapper per Hopper kernel plus its plain PyTorch twin
  csrc/              — the CUDA C++ kernels (sm_90a), built by nvcc at first use
  weights.py         — flat JAX variables <-> port modules; seeded init
  vocoder.py         — Griffin-Lim and WaveRNN vocoders
  synthesize.py      — ``Synthesizer``: texts + reference wavs -> waveforms
  losses.py          — the training losses
  train.py           — ``Trainer``: teacher-forced step, optimizer, eval hook
  checkpoint.py, metrics.py, utils/ — checkpoints, JSONL/TensorBoard logs,
                       the step-window profiler
  vocoder_train.py   — the WaveRNN vocoder's trainer

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
