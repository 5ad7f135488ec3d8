"""Training (counterpart of ``gst_tacotron_tpu/train.py``). For now only the
wav-transport step's feature materialization; the trainer comes later."""

from __future__ import annotations

from typing import Any, Dict

import torch

from .config import Config
from .dsp.torch_dsp import TorchDSP


def _materialize_features(cfg: Config, batch: Dict[str, Any]) -> Dict[str, Any]:
    """Wav-transport batches -> feature batches, on the tensors' device.

    Unpacks the loader's {"wav" float16, "ints" int32} wire batch and runs the
    plain feature path (``TorchDSP.features_precentered``, as the JAX step
    runs ``JaxDSP.features_precentered``). Frames past each utterance's true
    length are zeroed, so the result matches the zero-padded feature batches.
    A batch without "wav" is returned as it is."""
    if "wav" not in batch:
        return batch
    ints = batch["ints"]
    wav = batch["wav"].to(torch.float32)
    dsp = TorchDSP(cfg.audio, wav.device)
    tmax = ints.shape[1] - 4
    mel, lin = dsp.features_precentered(wav)
    true_frames = ints[:, tmax + 2]
    fmask = (torch.arange(mel.shape[1], device=mel.device)[None, :]
             < true_frames[:, None]).to(mel.dtype)[:, :, None]
    return {
        "tokens": ints[:, :tmax],
        "token_lengths": ints[:, tmax],
        "mel_lengths": ints[:, tmax + 1],
        "speaker_ids": ints[:, tmax + 3],
        "mel": mel * fmask,
        "linear": lin * fmask,
    }
