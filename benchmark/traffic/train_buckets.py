"""Training traffic over several buckets: ``train.py``'s feature batches,
one bucket a batch, in the order the mix's ``cycle`` lists them (each entry
a bucket's (max tokens, max frames)). A batch's rows carry the ``batch``
quantiles of the upper half of its bucket's text lengths and frames, as
``train.py``'s do; batch ``i`` draws its order and content from a seed of
its own made from the run's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import train


def batch_seed(seed: int, i: int) -> int:
    return (seed * 1_000_003 + 7919 * i) % (1 << 62)


def batches(mix: Dict, seed: int, num_mels: int, num_freq: int) -> List[Dict[str, np.ndarray]]:
    return [train.batches({"batch": mix["batch"], "batches": 1, "bucket": list(bucket)},
                          batch_seed(seed, i), num_mels, num_freq)[0]
            for i, bucket in enumerate(mix["cycle"])]
