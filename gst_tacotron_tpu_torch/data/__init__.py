"""Data layer: offline pattern prep and the online bucketed loader
(counterpart of ``gst_tacotron_tpu/data``). Numpy and scipy only."""

from .loader import Batch, BucketedLoader, PatternDataset, make_loader
from .pattern import (
    generate_patterns,
    synthetic_utterances,
    walk_ljspeech,
    walk_vctk,
)

__all__ = [
    "Batch",
    "BucketedLoader",
    "PatternDataset",
    "make_loader",
    "generate_patterns",
    "synthetic_utterances",
    "walk_ljspeech",
    "walk_vctk",
]
