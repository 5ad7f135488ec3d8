"""Audio DSP of the port: mel filterbank, host prep, PyTorch DSP and the
batched feature extractor. The names below are exported as the JAX
package's ``dsp/__init__.py`` exports them, each imported from its module
on first use: the host pattern workers import this package and must not
import torch."""

import importlib

_EXPORTS = {
    "TorchDSP": "torch_dsp",
    "amp_to_db": "torch_dsp",
    "db_to_amp": "torch_dsp",
    "normalize_db": "torch_dsp",
    "denormalize_db": "torch_dsp",
    "frame_indices": "torch_dsp",
    "num_frames_for": "torch_dsp",
    "mulaw_encode": "mulaw",
    "mulaw_decode": "mulaw",
    "mel_filterbank": "mel",
    "mel_pseudo_inverse": "mel",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
