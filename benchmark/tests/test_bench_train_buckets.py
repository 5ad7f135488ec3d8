"""The gst_lj.train_buckets cell on the CPU at small widths: the bucketed
training driver (``drivers/train_buckets.py``) against the plain
reference's steps, with the step broken underneath; the bucketed traffic's
sizes at the cell's mix."""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

import small
from benchmark import common
from benchmark.drivers import train_buckets
from benchmark.traffic import train_buckets as traffic

torch.set_num_threads(2)

CELL = "gst_lj.train_buckets"
MIX = {"generator": "train_buckets", "batch": 4,
       "cycle": [[24, 30], [16, 20], [8, 10], [16, 20]]}


def context(seed: int = 5, seconds: float = 0.3) -> common.Context:
    wl = copy.deepcopy(common.read_json(common.HERE / "workloads" / f"{CELL}.json"))
    wl["traffic"] = copy.deepcopy(MIX)
    return common.Context(cell=CELL, workload=wl, seed=seed, seconds=seconds, trace=False,
                          started=time.time(), device="cpu")


def test_sound_run_is_correct():
    res = train_buckets.run(context(), *small.config())
    assert res.correct, res.checks
    assert res.metrics["train_frames_per_s"] > 0 and res.failed == 0 and res.attempted >= 1
    assert res.layer["untraced"]["flops"] > 0
    limits = common.read_json(common.HERE / "workloads" / f"{CELL}.json")["limits"]
    assert {k: c["limit"] for k, c in res.checks.items()} == limits


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    import gst_tacotron_tpu_torch.train as port_train

    real = port_train.train_step

    def unchanged(tx, cfg, state, batch):
        saved = {k: p.detach().clone() for k, p in state.model.named_parameters()}
        out = real(tx, cfg, state, batch)
        with torch.no_grad():
            for k, p in state.model.named_parameters():
                p.copy_(saved[k])
        return out

    monkeypatch.setattr(port_train, "train_step", unchanged)
    res = train_buckets.run(context(), *small.config())
    assert not res.correct
    assert res.checks["change"]["value"] > res.checks["change"]["limit"]


def test_the_cells_mix():
    """8 batches of 32: 2 of (64, 400), 5 of (128, 800), 1 of (192, 1200),
    the first three one of each bucket (the warm-up the reference follows);
    each batch's rows the 32 quantiles of its bucket's upper half, 18,000
    frames a step on average; the seed orders and fills them."""
    mix = common.read_json(common.HERE / "traffic" / "train_b32_buckets.json")
    buckets = [tuple(c) for c in mix["cycle"]]
    assert sorted(buckets) == sorted([(64, 400)] * 2 + [(128, 800)] * 5 + [(192, 1200)])
    assert len(set(buckets[:3])) == 3
    out = traffic.batches(mix, 1234567890123, 80, 1025)
    frames = [int(b["mel_lengths"].sum()) for b in out]
    assert np.mean(frames) == 18000
    for b, (t, f) in zip(out, buckets):
        assert b["tokens"].shape == (32, t) and b["mel"].shape == (32, f, 80)
        assert sorted(b["mel_lengths"]) == [int(f // 2 + 1 + (f - f // 2 - 1) * (i + 0.5) / 32)
                                            for i in range(32)]
    again = traffic.batches(mix, 1234567890123, 80, 1025)
    assert all(np.array_equal(x["mel"], y["mel"]) for x, y in zip(out, again))
