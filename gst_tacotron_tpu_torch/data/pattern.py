"""Offline pattern generation (counterpart of ``gst_tacotron_tpu/data/pattern.py``).

Walks a corpus, cleans and tokenizes the transcripts, extracts mel and linear
features and writes one ``.npz`` pattern per utterance plus a JSON metadata
index with the lengths the loader buckets by. The files and the metadata are
those the JAX package writes, so either package's loader reads either's
corpus. Corpora:

  * ``ljspeech``: single speaker, ``metadata.csv`` + ``wavs/*.wav``;
  * ``vctk``: multi-speaker, ``txt/<spk>/*.txt`` + ``wav48/<spk>/*.wav``;
  * ``synthetic``: a deterministic token-driven corpus (harmonic stacks), so
    the pipeline runs with no audio files.

Features come from the host numpy DSP (``dsp/ref.py``), in a pool of
``spawn`` worker processes that import no torch and never touch CUDA, or with
``device_features=True`` from ``DeviceFeatureExtractor`` on the card (the
STFT kernel K3), in batched calls per bucket shape.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from math import gcd
from typing import Iterable, List, Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from ..config import AudioConfig, Config, get_preset, load_config
from ..dsp import ref as dsp_ref
from ..text import text_to_ids

METADATA_FILE = "metadata.json"


@dataclass
class Utterance:
    utt_id: str
    text: str
    wav_path: Optional[str]  # None for synthetic
    speaker: str
    speaker_id: int
    # synthetic wavs only: random per-token durations and inserted pauses,
    # so the token -> time map is not constant-slope
    nonlinear_durations: bool = False


# ---------------------------------------------------------------------------
# Corpus walkers
# ---------------------------------------------------------------------------


def walk_ljspeech(root: str) -> List[Utterance]:
    utts = []
    with open(os.path.join(root, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 2:
                continue
            utt_id = parts[0]
            text = parts[2] if len(parts) > 2 and parts[2] else parts[1]
            wav = os.path.join(root, "wavs", utt_id + ".wav")
            utts.append(Utterance(utt_id, text, wav, "LJ", 0))
    return utts


def walk_vctk(root: str) -> List[Utterance]:
    utts = []
    txt_root = os.path.join(root, "txt")
    speakers = sorted(os.listdir(txt_root)) if os.path.isdir(txt_root) else []
    for spk_idx, spk in enumerate(speakers):
        spk_dir = os.path.join(txt_root, spk)
        for fname in sorted(os.listdir(spk_dir)):
            if not fname.endswith(".txt"):
                continue
            utt_id = fname[:-4]
            with open(os.path.join(spk_dir, fname), encoding="utf-8") as f:
                text = f.read().strip()
            wav = None
            for wav_dir in ("wav48", "wav"):
                cand = os.path.join(root, wav_dir, spk, utt_id + ".wav")
                if os.path.exists(cand):
                    wav = cand
                    break
            if wav:
                utts.append(Utterance(utt_id, text, wav, spk, spk_idx))
    return utts


_SYNTH_SENTENCES = [
    "the quick brown fox jumps over the lazy dog.",
    "she sells sea shells by the sea shore.",
    "a stitch in time saves nine.",
    "all that glitters is not gold.",
    "actions speak louder than words.",
    "the early bird catches the worm.",
    "practice makes perfect every day.",
    "better late than never they say.",
    "every cloud has a silver lining.",
    "fortune favors the bold and the brave.",
    "honesty is the best policy in the end.",
    "knowledge is power and power is knowledge.",
    "look before you leap into the water.",
    "no news is good news for the waiting.",
    "the pen is mightier than the sword.",
    "when in rome do as the romans do.",
]


_SYNTH_WORDS = (
    "the a one this that every other through under over about after before "
    "against between without toward beyond quick slow bright dark heavy "
    "light early late young ancient quiet loud simple complex narrow wide "
    "golden silver frozen burning distant nearby hidden open broken whole "
    "fox dog river mountain valley forest harbor island meadow garden "
    "window doorway ladder bridge engine signal pattern stream thread "
    "crystal shadow thunder whisper journey morning evening winter summer "
    "autumn spring teacher sailor farmer painter doctor stranger neighbor "
    "children horses sparrows lanterns baskets letters stories numbers "
    "voices colors jumps runs walks sleeps dreams carries follows becomes "
    "remains appears vanishes gathers scatters remembers forgets discovers "
    "explains believes wonders listens answers questions travels returns "
    "arrives departs rises falls grows fades sings echoes drifts settles "
    "and but or while because although since when where how why if then "
    "slowly quickly quietly brightly together alone forever sometimes "
    "often rarely almost nearly quite very too also still again once"
).split()


def synthetic_utterances(n: int, num_speakers: int = 1, variable: bool = False,
                         nonlinear_durations: bool = False) -> List[Utterance]:
    """Deterministic synthetic corpus. ``variable=False`` cycles the 16
    sentences; ``variable=True`` composes unique word sequences of about
    12-170 characters, near-uniform, so a large corpus fills every length
    bucket. ``nonlinear_durations=True`` randomizes per-token segment lengths
    and inserts pauses (see ``synthesize_wav``)."""
    utts = []
    for i in range(n):
        spk = i % num_speakers
        if variable:
            rng = np.random.default_rng((0xC0A9, i))
            target_chars = int(rng.integers(12, 171))
            words = []
            length = 0
            while length < target_chars:
                w = _SYNTH_WORDS[int(rng.integers(0, len(_SYNTH_WORDS)))]
                words.append(w)
                length += len(w) + 1
            text = " ".join(words) + "."
        else:
            text = _SYNTH_SENTENCES[i % len(_SYNTH_SENTENCES)]
        utts.append(Utterance(f"synth_{i:05d}", text, None, f"S{spk}", spk,
                              nonlinear_durations=nonlinear_durations))
    return utts


def synthesize_wav(utt: Utterance, audio: AudioConfig) -> np.ndarray:
    """Deterministic token-driven harmonic stack standing in for speech: each
    token contributes a segment whose fundamental and formant mix depend on
    the token id, so the mel content follows the text."""
    tokens = text_to_ids(utt.text)
    base_seg = int(0.08 * audio.sample_rate)
    # a per-utterance seed from the id bytes (hash() is salted per process)
    seed = np.frombuffer(utt.utt_id.encode("utf-8").ljust(8, b"\0")[:8], np.uint64)[0]
    rng = np.random.default_rng((0x5EED, int(seed)))
    drng = np.random.default_rng((0xD07A, int(seed)))
    pieces = []
    phase = 0.0
    for tok in tokens:
        if utt.nonlinear_durations:
            # log-uniform per-token duration in [0.03, 0.19] s
            seg = int(base_seg * np.exp(drng.uniform(-0.98, 0.86)))
            if drng.random() < 0.06:
                # an inserted pause
                pieces.append(np.zeros(int(audio.sample_rate * drng.uniform(0.05, 0.25)),
                                       np.float64))
        else:
            seg = base_seg
        f0 = 90.0 + 12.0 * (tok % 23) + 25.0 * utt.speaker_id
        t = np.arange(seg) / audio.sample_rate
        sig = np.zeros(seg)
        for h, amp in ((1, 1.0), (2, 0.5), (3, 0.3), (4, 0.2)):
            sig += amp * np.sin(2 * np.pi * f0 * h * t + phase)
        formant = 500.0 + 80.0 * (tok % 11)
        sig *= 0.6 + 0.4 * np.sin(2 * np.pi * formant * t / 100.0)
        env = np.minimum(1.0, np.minimum(np.arange(seg), seg - np.arange(seg)) / (0.1 * seg))
        pieces.append(0.3 * sig * env + 0.005 * rng.standard_normal(seg))
        phase += 2 * np.pi * f0 * seg / audio.sample_rate
    return np.concatenate(pieces).astype(np.float32)


# ---------------------------------------------------------------------------
# Feature extraction
# ---------------------------------------------------------------------------


def load_wav(path: str, target_sr: int) -> np.ndarray:
    """A wav file as float32 mono at ``target_sr``: int16 and int32 scaled to
    [-1, 1), channels averaged, other rates resampled polyphase."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if sr != target_sr:
        g = gcd(sr, target_sr)
        wav = resample_poly(wav, target_sr // g, sr // g).astype(np.float32)
    return wav


def prepare_wav(utt: Utterance, audio: AudioConfig) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Host prep shared by both feature paths: tokenize, load or synthesize,
    trim, peak-normalize. Returns (tokens, wav), or None if too short."""
    tokens = np.asarray(text_to_ids(utt.text), np.int32)
    if utt.wav_path is None:
        wav = synthesize_wav(utt, audio)
    else:
        wav = dsp_ref.trim_silence(load_wav(utt.wav_path, audio.sample_rate), audio)
    if len(wav) < audio.n_fft:
        return None
    peak = np.abs(wav).max()
    if peak > 1.0:
        wav = wav / peak
    return tokens, wav


def write_pattern(utt: Utterance, tokens: np.ndarray, wav: np.ndarray,
                  mel: Optional[np.ndarray], linear: Optional[np.ndarray],
                  out_dir: str, store_wav: bool, mel_len: Optional[int] = None) -> dict:
    """Write one pattern file; returns its metadata entry. With no features
    (``mel`` None) the file is a wav-only shard: tokens and a float16
    waveform, the wire type of the wav transport."""
    path = os.path.join(out_dir, utt.utt_id + ".npz")
    arrays = dict(tokens=tokens, speaker_id=np.int32(utt.speaker_id), text=np.str_(utt.text))
    wav_only = mel is None
    if wav_only:
        arrays["wav"] = wav.astype(np.float16)
    else:
        arrays["mel"] = mel.astype(np.float32)
        arrays["linear"] = linear.astype(np.float32)
        if store_wav:
            arrays["wav"] = wav.astype(np.float32)
    np.savez_compressed(path, **arrays)
    return {
        "id": utt.utt_id,
        "file": os.path.basename(path),
        "text_len": int(len(tokens)),
        "mel_len": int(mel.shape[0]) if mel is not None else int(mel_len),
        "speaker_id": int(utt.speaker_id),
        "speaker": utt.speaker,
        "has_wav": bool(store_wav or wav_only),
        "wav_only": wav_only,
    }


def extract_pattern(utt: Utterance, audio: AudioConfig, out_dir: str,
                    store_wav: bool = False, wav_only: bool = False) -> Optional[dict]:
    """Extract (host numpy DSP) and write one pattern file.

    ``store_wav`` also stores the normalized waveform (vocoder training and
    the wav transport). ``wav_only`` skips the features and stores tokens and
    waveform only; its mel_len is the centred-STFT frame count
    1 + len(wav) // hop."""
    prep = prepare_wav(utt, audio)
    if prep is None:
        return None
    tokens, wav = prep
    if wav_only:
        return write_pattern(utt, tokens, wav, None, None, out_dir, True,
                             mel_len=1 + len(wav) // audio.hop_length)
    mel = dsp_ref.melspectrogram(wav, audio)
    linear = dsp_ref.spectrogram(wav, audio)
    return write_pattern(utt, tokens, wav, mel, linear, out_dir, store_wav)


def _device_feature_results(utts, audio, out_dir, store_wav, device=None,
                            chunk_size: int = 64):
    """Host prep (trim, normalize) in chunks, then one batched device call
    per bucket group for the STFT and mel work (K3 on the card)."""
    from ..dsp.device_features import DeviceFeatureExtractor

    extractor = DeviceFeatureExtractor(audio, device)
    for start in range(0, len(utts), chunk_size):
        prepped = [(u, prepare_wav(u, audio)) for u in utts[start: start + chunk_size]]
        kept = [(u, p) for u, p in prepped if p is not None]
        for _, p in prepped:
            if p is None:
                yield None
        if not kept:
            continue
        feats = extractor.extract([wav for _, (_, wav) in kept])
        for (u, (tokens, wav)), (mel, linear) in zip(kept, feats):
            yield write_pattern(u, tokens, wav, mel, linear, out_dir, store_wav)


def generate_patterns(
    utts: Iterable[Utterance],
    audio: AudioConfig,
    out_dir: str,
    num_workers: int = 1,
    max_text_len: int = 10000,
    max_mel_frames: int = 100000,
    store_wav: bool = False,
    device_features: bool = False,
    wav_only: bool = False,
    device=None,
) -> dict:
    """Write the corpus's patterns and ``metadata.json`` into ``out_dir``;
    returns the metadata. ``device`` is where ``device_features`` runs (the
    card unless ``"cpu"`` is given); the host path ignores it."""
    os.makedirs(out_dir, exist_ok=True)
    if wav_only and device_features:
        raise ValueError(
            "wav_only and device_features are mutually exclusive: wav-only "
            "shards skip feature extraction entirely (features are computed "
            "on the device at train time), so there is nothing for the device "
            "extractor to do")
    utts = list(utts)
    entries = []
    pool = None
    if device_features:
        results = _device_feature_results(utts, audio, out_dir, store_wav, device)
    elif num_workers > 1:
        pool = ProcessPoolExecutor(num_workers, mp_context=multiprocessing.get_context("spawn"))
        n = len(utts)
        results = pool.map(extract_pattern, utts, [audio] * n, [out_dir] * n,
                           [store_wav] * n, [wav_only] * n)
    else:
        results = (extract_pattern(u, audio, out_dir, store_wav, wav_only) for u in utts)
    try:
        for entry in results:
            if entry is None:
                continue
            if entry["text_len"] > max_text_len or entry["mel_len"] > max_mel_frames:
                continue
            entries.append(entry)
    finally:
        if pool is not None:
            pool.shutdown()

    speakers = sorted({e["speaker"] for e in entries})
    metadata = {
        # the full audio config: wav-only shards carry no features, so what
        # computes them later reads the exact parameters here
        "audio": dataclasses.asdict(audio),
        "num_speakers": len(speakers),
        "speakers": speakers,
        "entries": entries,
    }
    with open(os.path.join(out_dir, METADATA_FILE), "w") as f:
        json.dump(metadata, f)
    return metadata


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description="Offline pattern generation")
    p.add_argument("--corpus", choices=["ljspeech", "vctk", "synthetic"], required=True)
    p.add_argument("--path", help="corpus root (ljspeech/vctk)")
    p.add_argument("--out", required=True, help="output pattern directory")
    p.add_argument("--config", help="config JSON (default: preset taco1_lj)")
    p.add_argument("--num-utterances", type=int, default=200, help="synthetic corpus size")
    p.add_argument("--num-speakers", type=int, default=1, help="synthetic speaker count")
    p.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    p.add_argument("--store-wav", action="store_true",
                   help="also store waveforms (vocoder training, wav transport)")
    p.add_argument("--device-features", action="store_true",
                   help="extract features on the card (the batched STFT kernel) "
                        "instead of host numpy")
    p.add_argument("--device", default=None,
                   help="device of --device-features (default cuda; 'cpu' runs the "
                        "kernel's plain version)")
    p.add_argument("--wav-only", action="store_true",
                   help="store tokens + float16 waveform only, no features "
                        "(for the wav transport)")
    p.add_argument("--variable-lengths", action="store_true",
                   help="synthetic corpus: unique sentences of ~12-170 chars "
                        "(fills every bucket) instead of the 16-sentence cycle")
    p.add_argument("--nonlinear-durations", action="store_true",
                   help="synthetic corpus: random per-token durations and "
                        "inserted pauses")
    args = p.parse_args(argv)

    cfg: Config = load_config(args.config) if args.config else get_preset("taco1_lj")
    if args.corpus == "ljspeech":
        utts = walk_ljspeech(args.path)
    elif args.corpus == "vctk":
        utts = walk_vctk(args.path)
    else:
        utts = synthetic_utterances(args.num_utterances, args.num_speakers,
                                    variable=args.variable_lengths,
                                    nonlinear_durations=args.nonlinear_durations)
    meta = generate_patterns(utts, cfg.audio, args.out, num_workers=args.workers,
                             max_text_len=cfg.data.max_text_len,
                             max_mel_frames=cfg.data.max_mel_frames,
                             store_wav=args.store_wav,
                             device_features=args.device_features,
                             wav_only=args.wav_only, device=args.device)
    print(f"wrote {len(meta['entries'])} patterns to {args.out}")


if __name__ == "__main__":
    main()
