"""nn.Module counterparts of ``gst_tacotron_tpu/models``. The names below
are exported as the JAX package's ``models/__init__.py`` exports them, each
imported from its module on first use (the ops modules import submodules of
this package, so an eager import here would be circular)."""

import importlib

_EXPORTS = {
    "GSTTacotron": "tacotron",
    "Taco1Encoder": "encoder",
    "Taco2Encoder": "encoder",
    "GST": "gst",
    "ReferenceEncoder": "gst",
    "StyleTokenLayer": "gst",
    "Decoder": "decoder",
    "DecoderCell": "decoder",
    "PostCBHG": "postnet",
    "CBHG": "modules",
    "Conv1dBNStack": "modules",
    "Highway": "modules",
    "Prenet": "modules",
    "GRU": "rnn",
    "BiGRU": "rnn",
    "GRUCell": "rnn",
    "ZoneoutGRUCell": "rnn",
    "BahdanauAttention": "attention",
    "LocationSensitiveAttention": "attention",
    "make_attention": "attention",
    "init_attention_state": "attention",
    "alignment_diagonality": "attention",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
