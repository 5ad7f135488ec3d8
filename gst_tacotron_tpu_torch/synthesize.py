"""Synthesis (counterpart of ``gst_tacotron_tpu/synthesize.py::Synthesizer``).

(texts, reference wavs | token weights) -> tokens + reference mels ->
encoder + GST -> fixed-length AR decode -> post-net -> vocoder ->
waveforms, in the three stages of the JAX ``use_pallas_decoder`` mode:

  1. encode: text encoder, reference mels through the STFT kernel (K3), the
     GST conv stack (K2) and the reference GRU (K1), memory and keys;
  2. decode: the decode kernel (K4), Bahdanau or location-sensitive;
  3. finish: frame lengths from the stop logits, frame masking, post-net
     (its BiGRU through K1), Griffin-Lim, alignment diagonality.

With a ``WaveRNNVocoder`` the waveform comes from the masked decoded mel
through the sampling kernel (K5) instead of Griffin-Lim, drawn with seed
``seed + 104729``, as the JAX package offsets its vocoder's key.

On the card every kernel launches; with ``device="cpu"`` the same math runs
through the kernels' plain versions. ``plain=True`` picks the plain versions
on the card too, as the reference the kernels are held against.
``save_outputs`` writes the eval artifacts: 16-bit wavs, and alignment PNGs
where matplotlib imports.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from scipy.io import wavfile

from .config import Config
from .device import resolve_device
from .dsp.device_features import DeviceFeatureExtractor
from .dsp.torch_dsp import TorchDSP
from .models.attention import alignment_diagonality
from .models.tacotron import GSTTacotron
from .text import batch_text_to_ids

# the vocoder's seed offset from the call's seed (the JAX package's)
VOCODER_SEED_OFFSET = 104729


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Synthesizer:
    """Batch synthesis over a ``GSTTacotron`` with loaded weights."""

    def __init__(self, cfg: Config, model: GSTTacotron, *, device=None,
                 text_pad_multiple: int = 32, deterministic_prenet: bool = False,
                 plain: bool = False, vocoder=None):
        """deterministic_prenet: turn off the prenet dropout that otherwise
        stays on at inference, in both prenets; synthesis is then a
        deterministic function of (text, style).

        vocoder: a ``vocoder.make_vocoder`` object. None or a
        ``GriffinLimVocoder`` keeps Griffin-Lim inline; a ``WaveRNNVocoder``
        samples the waveform from the decoded mel."""
        self.cfg = cfg
        self.vocoder = vocoder
        self._inline_gl = vocoder is None or getattr(vocoder, "kind", "") == "griffin_lim"
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.text_pad_multiple = text_pad_multiple
        self.deterministic_prenet = deterministic_prenet
        self.plain = plain
        self.dsp = TorchDSP(cfg.audio, self.device)
        self._ref_extractor: Optional[DeviceFeatureExtractor] = None

    def _reference_mels(self, reference_wavs: Sequence[np.ndarray]):
        """Reference wavs -> (ref_mel (B, T, M) padded to a multiple of 64
        frames, lengths (B,))."""
        if self._ref_extractor is None:
            self._ref_extractor = DeviceFeatureExtractor(
                self.cfg.audio, self.device, plain=self.plain)
        mels = [m for m, _ in self._ref_extractor.extract(
            [np.asarray(w, np.float32) for w in reference_wavs])]
        t_max = _round_up(max(m.shape[0] for m in mels), 64)
        ref_mel = np.zeros((len(mels), t_max, self.cfg.model.num_mels), np.float32)
        for i, m in enumerate(mels):
            ref_mel[i, : m.shape[0]] = m
        lengths = np.array([m.shape[0] for m in mels], np.int64)
        return (torch.from_numpy(ref_mel).to(self.device),
                torch.from_numpy(lengths).to(self.device))

    @torch.no_grad()
    def __call__(self, texts: Sequence[str],
                 reference_wavs: Optional[Sequence[np.ndarray]] = None,
                 token_weights: Optional[np.ndarray] = None,
                 speaker_ids: Optional[Sequence[int]] = None,
                 max_steps: Optional[int] = None,
                 seed: int = 0) -> Dict[str, np.ndarray]:
        """``speaker_ids`` (a multi-speaker config) default to speaker 0."""
        cfg = self.cfg
        tokens, lengths = batch_text_to_ids(texts)
        pad_to = _round_up(tokens.shape[1], self.text_pad_multiple)
        tokens = np.pad(tokens, ((0, 0), (0, pad_to - tokens.shape[1])))
        dev = self.device

        ref_mel = ref_lengths = None
        if cfg.model.gst.enabled and reference_wavs is not None:
            ref_mel, ref_lengths = self._reference_mels(reference_wavs)
        elif cfg.model.gst.enabled and token_weights is None:
            # neutral style: uniform token weights
            token_weights = np.full((len(texts), cfg.model.gst.num_tokens),
                                    1.0 / cfg.model.gst.num_tokens, np.float32)
        tw = None if token_weights is None else torch.as_tensor(
            np.asarray(token_weights, np.float32), device=dev)

        spk = None
        if cfg.model.num_speakers > 1:
            spk = torch.as_tensor(np.asarray(
                speaker_ids if speaker_ids is not None else [0] * len(texts), np.int64),
                device=dev)
        tok = torch.from_numpy(tokens.astype(np.int64)).to(dev)
        tok_len = torch.from_numpy(lengths.astype(np.int64)).to(dev)
        steps = max_steps or cfg.model.decoder.max_decode_steps
        out = self.model.infer(
            tok, tok_len, ref_mel, ref_lengths, tw, speaker_ids=spk, max_steps=steps,
            deterministic_prenet=self.deterministic_prenet, seed=seed,
            plain=self.plain)
        if self._inline_gl:
            wav = self.dsp.inv_linear_spectrogram(out["linear"])
        else:
            wav = self.vocoder(out, seed=seed + VOCODER_SEED_OFFSET, plain=self.plain)
        r = cfg.model.decoder.reduction_factor
        out["diagonality"] = alignment_diagonality(
            out["alignments"], tok_len, torch.clamp(out["frame_lengths"] // r, min=1))
        result = {k: v.cpu().numpy() for k, v in out.items()}
        result["wav"] = wav.cpu().numpy()
        result["wav_lengths"] = result["frame_lengths"] * cfg.audio.hop_length
        return result

    # -- artifacts ----------------------------------------------------------

    def save_outputs(self, outputs: Dict[str, np.ndarray], out_dir: str,
                     prefix: str = "synth") -> List[str]:
        """Write each row's wav (16-bit, cut to its length) and, where
        matplotlib imports, its alignment PNG; returns the paths."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        sr = self.cfg.audio.sample_rate
        for i in range(outputs["wav"].shape[0]):
            n = int(outputs["wav_lengths"][i])
            wav = np.clip(outputs["wav"][i, :n], -1.0, 1.0)
            path = os.path.join(out_dir, f"{prefix}_{i:03d}.wav")
            wavfile.write(path, sr, (wav * 32767).astype(np.int16))
            paths.append(path)
            png = save_alignment_png(outputs["alignments"][i], out_dir, f"{prefix}_{i:03d}")
            if png:
                paths.append(png)
        return paths


def save_alignment_png(alignment: np.ndarray, out_dir: str, name: str) -> Optional[str]:
    """(S, T) alignment -> ``<name>_align.png``; None where matplotlib does
    not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    path = os.path.join(out_dir, f"{name}_align.png")
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.imshow(alignment.T, aspect="auto", origin="lower", interpolation="none")
    ax.set_xlabel("decoder step")
    ax.set_ylabel("encoder position")
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path
