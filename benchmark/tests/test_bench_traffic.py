"""The traffic generators: deterministic in the seed, every seed the same
sizes, the lengths the mix states."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import common
from benchmark.reference import tacotron
from benchmark.traffic import synth

MIX = common.read_json(common.HERE / "traffic" / "synth_b32.json")
SR = 22050


def _small():
    return {**MIX, "batches": 3}


def test_deterministic_in_the_seed():
    a, b = synth.batches(_small(), 2 ** 33 + 5, SR), synth.batches(_small(), 2 ** 33 + 5, SR)
    for (ta, wa), (tb, wb) in zip(a, b):
        assert ta == tb
        assert all(np.array_equal(x, y) for x, y in zip(wa, wb))


def test_every_seed_and_batch_the_same_sizes():
    sizes = set()
    for seed in (1, 2, 3 * 10 ** 9):
        for texts, wavs in synth.batches(_small(), seed, SR):
            sizes.add((tuple(sorted(len(t) for t in texts)), tuple(sorted(len(w) for w in wavs))))
    assert len(sizes) == 1
    a, b = synth.batches(_small(), 1, SR)[0], synth.batches(_small(), 2, SR)[0]
    assert a[0] != b[0]


def test_lengths_follow_the_mix():
    p = MIX["text_chars"]
    n = synth.text_lengths(p, MIX["batch"])
    assert len(n) == MIX["batch"] == 32
    assert n.min() >= p["min"] and n.max() <= p["max"]
    assert np.median(n) == pytest.approx(p["median"], abs=2)
    s = synth.wav_seconds(MIX["ref_seconds"], 32)
    assert s.min() > MIX["ref_seconds"]["min"] and s.max() < MIX["ref_seconds"]["max"]
    assert np.mean(s) == pytest.approx((MIX["ref_seconds"]["min"] + MIX["ref_seconds"]["max"]) / 2)


def test_cleaned_texts_keep_their_length():
    texts, wavs = synth.batches(_small(), 9, SR)[0]
    ids, lengths = tacotron.text_ids(texts, 32)
    assert sorted(lengths - 1) == sorted(synth.text_lengths(MIX["text_chars"], 32))
    assert ids.shape[1] == 192
    assert all(w.dtype == np.float32 and np.abs(w).max() < 1.5 for w in wavs)


def test_call_seeds_differ():
    seeds = {synth.call_seed(3 * 10 ** 9, i) for i in range(-2, 1000)}
    assert len(seeds) == 1002 and all(0 <= s < 2 ** 62 for s in seeds)
