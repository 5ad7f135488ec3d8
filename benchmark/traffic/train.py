"""Training traffic: feature batches of one bucket, as the loader hands
them to the train step (tokens, token lengths, mel, mel lengths, linear,
speaker ids; the feature transport).

Every seed and every batch carries the same lengths: the ``batch``
quantiles, at (i + 0.5) / batch, of a uniform over the bucket's upper half
of text lengths and of frames. The seed orders them across each batch's
rows and draws the content, as the port's train bench draws it: token ids
in [2, 40), mel and linear values uniform in [0, 1); past each row's
length tokens are 0 and frames are zero, as the loader pads them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def lengths(lo: int, hi: int, batch: int) -> np.ndarray:
    """``batch`` quantiles of a uniform over [lo, hi], shortest first."""
    return np.array([int(lo + (hi - lo) * (i + 0.5) / batch) for i in range(batch)])


def batches(mix: Dict, seed: int, num_mels: int, num_freq: int) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    b = mix["batch"]
    max_text, max_frames = mix["bucket"]
    texts = lengths(max_text // 2 + 1, max_text, b)
    frames = lengths(max_frames // 2 + 1, max_frames, b)
    out = []
    for _ in range(mix["batches"]):
        tl, fl = rng.permutation(texts), rng.permutation(frames)
        tok = rng.integers(2, 40, (b, max_text)).astype(np.int32)
        tok[np.arange(max_text)[None, :] >= tl[:, None]] = 0
        live = (np.arange(max_frames)[None, :] < fl[:, None])[..., None]
        mel = rng.random((b, max_frames, num_mels), np.float32) * live
        lin = rng.random((b, max_frames, num_freq), np.float32) * live
        out.append({"tokens": tok, "token_lengths": tl.astype(np.int32), "mel": mel,
                    "mel_lengths": fl.astype(np.int32), "linear": lin,
                    "speaker_ids": np.zeros((b,), np.int32)})
    return out
