"""Synthesis (counterpart of ``gst_tacotron_tpu/synthesize.py::Synthesizer``).

(texts, reference wavs | token weights) -> tokens + reference mels ->
encoder + GST -> fixed-length AR decode -> post-net -> vocoder ->
waveforms, in the three stages of the JAX ``use_pallas_decoder`` mode:

  1. encode: text encoder, reference mels through the STFT kernel (K3), the
     GST conv stack (K2) and the reference GRU (K1), memory and keys;
  2. decode: the decode kernel (K4), Bahdanau or location-sensitive;
  3. finish: frame lengths from the stop logits, frame masking, post-net
     (its BiGRU through K1), Griffin-Lim, alignment diagonality.

Tacotron 2's conv post-net refines the mel (``mel_postnet``) instead of
predicting a linear spectrogram; Griffin-Lim then starts from the mel
basis's pseudo-inverse of it (``TorchDSP.mel_to_linear``, span
``gst.synth.mel_to_linear``).

With a ``WaveRNNVocoder`` the waveform comes from the masked decoded mel
through the sampling kernel (K5) instead of Griffin-Lim, drawn with seed
``seed + 104729``, as the JAX package offsets its vocoder's key.

On the card every kernel launches; with ``device="cpu"`` the same math runs
through the kernels' plain versions. ``plain=True`` picks the plain versions
on the card too, as the reference the kernels are held against. As the JAX
``Synthesizer`` on its accelerator, the reference path on the card runs K3
and K2 in their bf16 operand modes; ``bf16=False`` pins it to float32 (the
function JAX computes on the CPU).
``save_outputs`` writes the eval artifacts: 16-bit wavs, and alignment PNGs
where matplotlib imports. ``benchmark_synthesis`` times a ``Synthesizer``;
``main`` is the command line (``python -m gst_tacotron_tpu_torch.synthesize``),
restoring a checkpoint of the port's trainer or a JAX workdir exported by
``tools/export_jax_workdir.py``.
"""

from __future__ import annotations

import argparse
import os
import re
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from scipy.io import wavfile

from .config import Config
from .device import HostCopies, resolve_device
from .dsp.device_features import DeviceFeatureExtractor
from .dsp.torch_dsp import TorchDSP
from .metrics import synthesis_metrics
from .models.attention import alignment_diagonality
from .models.tacotron import GSTTacotron
from .text import batch_text_to_ids
from .utils.profiling import count, next_call, span

# the vocoder's seed offset from the call's seed (the JAX package's)
VOCODER_SEED_OFFSET = 104729
# the key under which ``__call__`` hands ``to_host`` the copies it started
_STARTED = "_host_copies"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _start_copies(out: Dict, copies: HostCopies) -> int:
    """Start the host copies of ``out``'s tensors that ``copies`` lacks,
    floating ones as float32; the bytes enqueued from the card."""
    return copies.start({k: v.float() if v.is_floating_point() else v
                         for k, v in out.items() if torch.is_tensor(v) and k not in copies})


class Synthesizer:
    """Batch synthesis over a ``GSTTacotron`` with loaded weights."""

    def __init__(self, cfg: Config, model: GSTTacotron, *, device=None,
                 text_pad_multiple: int = 32, deterministic_prenet: bool = False,
                 plain: bool = False, vocoder=None, use_chunked_decoder: bool = False,
                 chunk_steps: int = 64, bf16: Optional[bool] = None):
        """deterministic_prenet: turn off the prenet dropout that otherwise
        stays on at inference, in both prenets; synthesis is then a
        deterministic function of (text, style).

        use_chunked_decoder: decode in ``chunk_steps`` chunks and stop once
        every row's stop token fired (``decode.chunked_decode``, each chunk
        one resumed K4 call on the card); the result has ``chunks_run``.

        vocoder: a ``vocoder.make_vocoder`` object. None or a
        ``GriffinLimVocoder`` keeps Griffin-Lim inline; a ``WaveRNNVocoder``
        samples the waveform from the decoded mel.

        bf16: the reference path's bf16 operand modes (K3's resident route,
        K2's stack); None resolves each as JAX does: on for the card at the
        shapes where JAX takes them, off on the CPU."""
        self.cfg = cfg
        self.vocoder = vocoder
        self._inline_gl = vocoder is None or getattr(vocoder, "kind", "") == "griffin_lim"
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.text_pad_multiple = text_pad_multiple
        self.deterministic_prenet = deterministic_prenet
        self.plain = plain
        self.bf16 = bf16
        self.chunk_steps = chunk_steps if use_chunked_decoder else None
        self.dsp = TorchDSP(cfg.audio, self.device)
        self._ref_extractor: Optional[DeviceFeatureExtractor] = None

    def _reference_mels(self, reference_wavs: Sequence[np.ndarray],
                        frames: Optional[int] = None):
        """Reference wavs -> (ref_mel (B, T, M) padded to a multiple of 64
        frames, at least ``frames``, lengths (B,))."""
        if self._ref_extractor is None:
            self._ref_extractor = DeviceFeatureExtractor(
                self.cfg.audio, self.device, plain=self.plain, bf16=self.bf16)
        mels = [m for m, _ in self._ref_extractor.extract(
            [np.asarray(w, np.float32) for w in reference_wavs])]
        t_max = _round_up(max([m.shape[0] for m in mels] + [frames or 0]), 64)
        ref_mel = np.zeros((len(mels), t_max, self.cfg.model.num_mels), np.float32)
        for i, m in enumerate(mels):
            ref_mel[i, : m.shape[0]] = m
        lengths = np.array([m.shape[0] for m in mels], np.int64)
        return (torch.from_numpy(ref_mel).to(self.device),
                torch.from_numpy(lengths).to(self.device))

    def text_inputs(self, texts: Sequence[str], style_from_wavs: bool,
                    token_weights: Optional[np.ndarray] = None,
                    speaker_ids: Optional[Sequence[int]] = None
                    ) -> Dict[str, Optional[np.ndarray]]:
        """The host front end of ``texts``: {tokens (B, L) padded to a
        multiple of ``text_pad_multiple``, token_lengths, token_weights
        (uniform, the neutral style, for a GST config without a style
        source), speaker_ids (0 by default, multi-speaker configs)}."""
        cfg = self.cfg
        tokens, lengths = batch_text_to_ids(texts)
        pad_to = _round_up(tokens.shape[1], self.text_pad_multiple)
        tokens = np.pad(tokens, ((0, 0), (0, pad_to - tokens.shape[1])))
        if cfg.model.gst.enabled and not style_from_wavs and token_weights is None:
            token_weights = np.full((len(texts), cfg.model.gst.num_tokens),
                                    1.0 / cfg.model.gst.num_tokens, np.float32)
        spk = None
        if cfg.model.num_speakers > 1:
            spk = np.asarray(speaker_ids if speaker_ids is not None else [0] * len(texts),
                             np.int64)
        return {"tokens": tokens.astype(np.int64), "token_lengths": lengths.astype(np.int64),
                "token_weights": None if token_weights is None
                else np.asarray(token_weights, np.float32), "speaker_ids": spk}

    @torch.no_grad()
    def infer(self, tok: torch.Tensor, tok_len: torch.Tensor,
              ref_mel: Optional[torch.Tensor], ref_lengths: Optional[torch.Tensor],
              token_weights: Optional[torch.Tensor], speaker_ids: Optional[torch.Tensor], *,
              max_steps: int, seed: int, deterministic_prenet: bool,
              chunk_steps: Optional[int], stop_all_reduce=None,
              copies: Optional[HostCopies] = None) -> Dict[str, torch.Tensor]:
        """The model's ``infer`` on device inputs, then the waveform
        (``wav``): every output on the device. Given ``copies``, the copies
        to the host of every output but the waveform, with the alignments'
        ``diagonality``, start before the vocoder, which they overlap
        (counted as ``d2h_early_bytes``)."""
        out = self.model.infer(
            tok, tok_len, ref_mel, ref_lengths, token_weights, speaker_ids=speaker_ids,
            max_steps=max_steps, deterministic_prenet=deterministic_prenet, seed=seed,
            plain=self.plain, chunk_steps=chunk_steps, stop_all_reduce=stop_all_reduce,
            bf16=self.bf16)
        if copies is not None:
            out["diagonality"] = self._diagonality(out, tok_len)
            count("d2h_early_bytes", _start_copies(out, copies))
        with span("gst.synth.vocoder"):
            if self._inline_gl and "linear" in out:
                out["wav"] = self.dsp.inv_linear_spectrogram(out["linear"].float())
            elif self._inline_gl:
                with span("gst.synth.mel_to_linear"):
                    amp = self.dsp.mel_to_linear(out["mel_postnet"].float())
                out["wav"] = self.dsp.inv_amplitude(amp)
            else:
                out["wav"] = self.vocoder(out, seed=seed + VOCODER_SEED_OFFSET,
                                          plain=self.plain)
        return out

    def _diagonality(self, out: Dict[str, torch.Tensor], tok_len: torch.Tensor
                     ) -> torch.Tensor:
        r = self.cfg.model.decoder.reduction_factor
        return alignment_diagonality(out["alignments"], tok_len,
                                     torch.clamp(out["frame_lengths"] // r, min=1))

    def to_host(self, out: Dict[str, torch.Tensor], tok_len: torch.Tensor
                ) -> Dict[str, np.ndarray]:
        """Outputs -> host arrays, with the alignments' diagonality and the
        waveforms' lengths. The copies ``__call__`` started before the
        vocoder are joined by the rest, and the host waits once for all of
        them (``device.HostCopies``; ``d2h_bytes``, ``host_syncs``)."""
        copies = out.pop(_STARTED, None)
        if copies is None:
            copies = HostCopies()
        if "diagonality" not in out:
            out["diagonality"] = self._diagonality(out, tok_len)
        _start_copies(out, copies)
        arrays = copies.wait()
        result = {k: arrays.get(k, v) for k, v in out.items() if k != "diagonality"}
        result["diagonality"] = arrays["diagonality"]
        result["wav_lengths"] = result["frame_lengths"] * self.cfg.audio.hop_length
        return result

    @torch.no_grad()
    def __call__(self, texts: Sequence[str],
                 reference_wavs: Optional[Sequence[np.ndarray]] = None,
                 token_weights: Optional[np.ndarray] = None,
                 speaker_ids: Optional[Sequence[int]] = None,
                 max_steps: Optional[int] = None,
                 seed: int = 0) -> Dict[str, np.ndarray]:
        """``speaker_ids`` (a multi-speaker config) default to speaker 0."""
        cfg = self.cfg
        dev = self.device
        with span("gst.synth", call=next_call()):
            from_wavs = cfg.model.gst.enabled and reference_wavs is not None
            with span("gst.synth.frontend"):
                host = self.text_inputs(texts, from_wavs, token_weights, speaker_ids)
            ref_mel = ref_lengths = None
            if from_wavs:
                with span("gst.synth.ref_mels"):
                    ref_mel, ref_lengths = self._reference_mels(reference_wavs)
            with span("gst.synth.h2d"):
                tok, tok_len, weights, spk = (
                    None if host[k] is None else torch.from_numpy(host[k]).to(dev)
                    for k in ("tokens", "token_lengths", "token_weights", "speaker_ids"))
            with span("gst.synth.infer"):
                copies = HostCopies()
                out = self.infer(tok, tok_len, ref_mel, ref_lengths, weights, spk,
                                 max_steps=max_steps or cfg.model.decoder.max_decode_steps,
                                 seed=seed, deterministic_prenet=self.deterministic_prenet,
                                 chunk_steps=self.chunk_steps, copies=copies)
                out[_STARTED] = copies
            with span("gst.synth.to_host"):
                return self.to_host(out, tok_len)

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


def benchmark_synthesis(synth: Synthesizer, texts: Sequence[str], iterations: int = 3,
                        **kwargs) -> Dict[str, float]:
    """``synthesis_metrics`` of ``synth(texts, **kwargs)``: one untimed call
    (it builds the kernels), then the mean host wall time of ``iterations``
    calls, each ending with its results on the host and one synchronize. One
    card: the ``Synthesizer`` runs on one device."""
    def call():
        out = synth(texts, **kwargs)
        if synth.device.type == "cuda":
            torch.cuda.synchronize(synth.device)
        return out

    out = call()
    t0 = time.perf_counter()
    for _ in range(iterations):
        out = call()
    dt = (time.perf_counter() - t0) / iterations
    audio_seconds = float(np.sum(out["wav_lengths"])) / synth.cfg.audio.sample_rate
    decode_steps = int(np.sum(out["frame_lengths"]) // synth.cfg.model.decoder.reduction_factor)
    return synthesis_metrics(audio_seconds, dt, decode_steps, num_chips=1)


def main(argv=None):
    """Restore a checkpoint of the port's trainer (or an exported JAX one),
    synthesize texts, write wavs and alignment PNGs."""
    from .checkpoint import CheckpointManager
    from .config import apply_overrides, get_preset, load_config, parse_cli_overrides
    from .vocoder import make_vocoder
    from .weights import build_model

    p = argparse.ArgumentParser(description="Synthesize speech (PyTorch port)")
    p.add_argument("--preset", default="taco1_lj")
    p.add_argument("--config")
    p.add_argument("--workdir", required=True,
                   help="a training workdir of the port, or a JAX one exported by "
                        "tools/export_jax_workdir.py: config.json and checkpoints/")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--texts", nargs="+", required=True)
    p.add_argument("--reference-wavs", nargs="*", help="style reference wavs (GST configs)")
    p.add_argument("--token-weights",
                   help="direct style control: comma-separated token weights "
                        "(model.gst.num_tokens of them) for every utterance; mutually "
                        "exclusive with --reference-wavs")
    p.add_argument("--speaker-ids", nargs="*", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default cuda; 'cpu' runs the plain path on the CPU")
    p.add_argument("--pallas-decoder", action="store_true",
                   help="accepted for the JAX CLI's sake: the decode kernel (K4) is the "
                        "port's default route on the card")
    p.add_argument("--chunked-decoder", action="store_true",
                   help="decode in chunks with early exit (each chunk a resumed K4 call)")
    p.add_argument("--vocoder", choices=["config", "griffin_lim", "wavernn"],
                   default="config", help="waveform stage; 'config' uses model.vocoder.kind")
    p.add_argument("--vocoder-workdir",
                   help="vocoder_train workdir with vocoder_ckpt/, the port's or an "
                        "exported JAX one (wavernn; defaults to --workdir)")
    p.add_argument("--profile",
                   help="trace the synthesis call into this directory (torch.profiler)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    # a trailing key.path=value goes to the greedy --texts
    for t in args.texts:
        if re.fullmatch(r"[A-Za-z_][\w.]*=[^\s=]+", t):
            p.error(f"{t!r} looks like a config override but was captured by --texts; "
                    f"put overrides BEFORE --texts")

    workdir_cfg = os.path.join(args.workdir, "config.json")
    if args.config:
        cfg = load_config(args.config)
    elif os.path.exists(workdir_cfg):
        cfg = load_config(workdir_cfg)
    else:
        cfg = get_preset(args.preset)
    if args.overrides:
        cfg = apply_overrides(cfg, parse_cli_overrides(args.overrides))
    ckpt_dir = os.path.join(args.workdir, cfg.train.checkpoint_dir)
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint directory at {ckpt_dir}")

    token_weights = None
    if args.token_weights:
        if args.reference_wavs:
            p.error("--token-weights and --reference-wavs are mutually exclusive "
                    "(two style sources)")
        w = np.array([float(x) for x in args.token_weights.split(",")], np.float32)
        if w.shape[0] != cfg.model.gst.num_tokens:
            p.error(f"--token-weights needs {cfg.model.gst.num_tokens} values "
                    f"(model.gst.num_tokens), got {w.shape[0]}")
        if not cfg.model.gst.enabled:
            p.error("--token-weights requires a GST config (model.gst.enabled)")
        token_weights = np.tile(w[None, :], (len(args.texts), 1))

    device = resolve_device(args.device)
    model = build_model(cfg, seed=cfg.train.seed, device=device)
    ckpt = CheckpointManager(ckpt_dir)
    saved = ckpt.restore(map_location=device)
    model.load_state_dict(saved["model"])
    print(f"restored checkpoint at step {int(saved['step'])}")

    vocoder = None
    kind = cfg.model.vocoder.kind if args.vocoder == "config" else args.vocoder
    if kind == "wavernn":
        vworkdir = args.vocoder_workdir or args.workdir
        vocoder = make_vocoder(apply_overrides(cfg, {"model.vocoder.kind": "wavernn"}),
                               vocoder_workdir=vworkdir, device=device)
        print(f"restored wavernn vocoder from {vworkdir}")

    synth = Synthesizer(cfg, model, device=device, vocoder=vocoder,
                        use_chunked_decoder=args.chunked_decoder)
    ref_wavs = None
    if args.reference_wavs:
        from .data.pattern import load_wav

        ref_wavs = [load_wav(w, cfg.audio.sample_rate) for w in args.reference_wavs]
    from .utils.profiling import profile_trace

    with profile_trace(args.profile, enabled=args.profile is not None):
        out = synth(args.texts, reference_wavs=ref_wavs, token_weights=token_weights,
                    speaker_ids=args.speaker_ids, seed=args.seed)
    paths = synth.save_outputs(out, args.out)
    for pth, d in zip([x for x in paths if x.endswith(".wav")], out["diagonality"]):
        print(f"{pth}  (alignment diagonality {float(d):.3f})")
    return paths


if __name__ == "__main__":
    main()
