"""Synthesis traffic: batches of texts and style wavs, from a mix's
parameters and the run's seed.

Every seed gets the same sizes. A batch's text lengths are the ``batch``
quantiles, at (i + 0.5) / batch, of a log-normal clipped to [min, max]
characters; its style wavs' durations the same quantiles of a uniform
range of seconds. The seed orders them across the rows of each batch and
draws the content: letters with single spaces between words (no space at
either end, none beside another, so the cleaned text keeps its length),
and a harmonic voice-like wav (a fundamental of 90-250 Hz and three
overtones, a slow amplitude envelope, a little noise), as the port's
chip smoke test draws them.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import numpy as np

LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def text_lengths(p: Dict, batch: int) -> np.ndarray:
    """The mix's ``batch`` text lengths in characters, shortest first."""
    nd = statistics.NormalDist()
    q = [(i + 0.5) / batch for i in range(batch)]
    raw = [p["median"] * np.exp(p["sigma"] * nd.inv_cdf(x)) for x in q]
    return np.clip(np.rint(raw), p["min"], p["max"]).astype(np.int64)


def wav_seconds(p: Dict, batch: int) -> np.ndarray:
    """The mix's ``batch`` style-wav durations, shortest first."""
    return np.array([p["min"] + (p["max"] - p["min"]) * (i + 0.5) / batch
                     for i in range(batch)])


def text(rng: np.random.Generator, n: int) -> str:
    chars = rng.choice(LETTERS, n)
    slots = np.arange(2, n - 2, 3)
    spaces = rng.choice(slots, min(len(slots), n // 6), replace=False) if len(slots) else []
    chars[spaces] = " "
    return "".join(chars)


def voice(rng: np.random.Generator, samples: int, sr: int) -> np.ndarray:
    t = np.arange(samples) / sr
    f0 = rng.uniform(90, 250)
    wav = sum(0.5 ** k * np.sin(2 * np.pi * (k + 1) * f0 * t + rng.uniform(0, 6.3))
              for k in range(4))
    wav = wav * (0.3 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.5, 3) * t))
    return (wav + rng.normal(0, 0.01, samples)).astype(np.float32)


def batches(mix: Dict, seed: int, sample_rate: int) -> List[Tuple[List[str], List[np.ndarray]]]:
    """``mix["batches"]`` batches of ``mix["batch"]`` (texts, style wavs)."""
    rng = np.random.default_rng(seed)
    b = mix["batch"]
    lengths = text_lengths(mix["text_chars"], b)
    seconds = wav_seconds(mix["ref_seconds"], b)
    out = []
    for _ in range(mix["batches"]):
        tl, ws = rng.permutation(lengths), rng.permutation(seconds)
        texts = [text(rng, int(n)) for n in tl]
        wavs = [voice(rng, int(round(s * sample_rate)), sample_rate) for s in ws]
        out.append((texts, wavs))
    return out


def call_seed(seed: int, i: int) -> int:
    """The dropout and sampling seed of call ``i``: distinct per call, from
    the run's seed."""
    return (seed * 1_000_003 + 7919 * i) % (1 << 62)
