"""Parity harness (counterpart of ``gst_tacotron_tpu/parity.py``): mel MAE,
max error, MCD and allclose between a ``Synthesizer`` and golden fixtures.

A fixture is a ``.npz`` of ``text``, the expected ``mel`` (T, M) and an
optional reference wav ``ref_wav``; other ``.npz`` files in the directory
(the golden params pack) are skipped.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from typing import List, Optional

import numpy as np

from .metrics import mel_cepstral_distortion


@dataclass
class ParityResult:
    name: str
    mel_mae: float
    mel_max_err: float
    mcd_db: float
    allclose_1e2: bool
    allclose_1e3: bool


def save_fixture(path: str, text: str, mel: np.ndarray,
                 ref_wav: Optional[np.ndarray] = None) -> None:
    arrays = {"text": np.str_(text), "mel": np.asarray(mel, np.float32)}
    if ref_wav is not None:
        arrays["ref_wav"] = np.asarray(ref_wav, np.float32)
    np.savez_compressed(path, **arrays)


def run_parity(synth, fixture_dir: str, report_path: Optional[str] = None
               ) -> List[ParityResult]:
    """Synthesize each fixture's text (seed 0) with ``synth`` and compare its
    mel over the shorter of the two lengths; with ``report_path``, write the
    results there as JSON."""
    results = []
    for fname in sorted(os.listdir(fixture_dir)):
        if not fname.endswith(".npz"):
            continue
        with np.load(os.path.join(fixture_dir, fname), allow_pickle=False) as z:
            if "text" not in z or "mel" not in z:
                continue
            text = str(z["text"])
            expected = z["mel"]
            ref_wav = z["ref_wav"] if "ref_wav" in z else None
        out = synth([text], reference_wavs=[ref_wav] if ref_wav is not None else None, seed=0)
        frames = min(int(out["frame_lengths"][0]), expected.shape[0])
        got, exp = out["mel"][0, :frames], expected[:frames]
        err = np.abs(got - exp)
        results.append(ParityResult(
            name=fname, mel_mae=float(err.mean()), mel_max_err=float(err.max()),
            mcd_db=mel_cepstral_distortion(got, exp),
            allclose_1e2=bool(np.allclose(got, exp, atol=1e-2)),
            allclose_1e3=bool(np.allclose(got, exp, atol=1e-3))))
    if report_path:
        with open(report_path, "w") as f:
            json.dump([asdict(r) for r in results], f, indent=2)
    return results
