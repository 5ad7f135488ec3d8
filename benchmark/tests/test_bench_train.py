"""The training driver end to end on the CPU at small widths (the port's
``train_step`` against the plain reference's steps), with the step broken
underneath, and the training traffic."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import small
from benchmark import common
from benchmark.drivers import train
from benchmark.traffic import train as traffic

torch.set_num_threads(2)


def test_sound_run_is_correct():
    res = train.run(small.train_context(), *small.config())
    assert res.correct, res.checks
    assert res.metrics["train_frames_per_s"] > 0 and res.failed == 0
    assert set(res.checks) == {f"{p}{k}" for p in ("", "window_")
                               for k in ("loss", "grad", "change", "change_worst")}


def _patch_step(monkeypatch, fn):
    import gst_tacotron_tpu_torch.train as port_train

    real = port_train.train_step
    monkeypatch.setattr(port_train, "train_step", lambda tx, cfg, state, batch:
                        fn(real, tx, cfg, state, batch))


def _unchanged(real, tx, cfg, state, batch):
    saved = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    out = real(tx, cfg, state, batch)
    with torch.no_grad():
        for k, p in state.model.named_parameters():
            p.copy_(saved[k])
    return out


def _half(real, tx, cfg, state, batch):
    n = batch["tokens"].shape[0] // 2
    return real(tx, cfg, state, {k: v[:n] for k, v in batch.items()})


def _altered_loss(real, tx, cfg, state, batch):
    out = real(tx, cfg, state, batch)
    return {**out, "loss": out["loss"] * 1.01}


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    _patch_step(monkeypatch, _unchanged)
    res = train.run(small.train_context(), *small.config())
    assert res.checks["change"]["value"] > res.checks["change"]["limit"]
    assert not res.correct


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    _patch_step(monkeypatch, _half)
    assert not train.run(small.train_context(), *small.config()).correct


def test_an_altered_loss_is_not_correct(monkeypatch):
    _patch_step(monkeypatch, _altered_loss)
    res = train.run(small.train_context(), *small.config())
    assert res.checks["loss"]["value"] > res.checks["loss"]["limit"]


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered_loss],
                         ids=["unchanged", "half", "altered_loss"])
def test_a_fault_only_once_warmed_up_is_not_correct(monkeypatch, fault):
    """A step that goes wrong only after the warm-up (as a step captured
    or compiled there and replayed later could): the first steps pass, the
    step judged from the window's state does not."""
    taken = []

    def late(real, tx, cfg, state, batch):
        taken.append(1)
        if len(taken) <= train.WARM_STEPS:
            return real(tx, cfg, state, batch)
        return fault(real, tx, cfg, state, batch)

    _patch_step(monkeypatch, late)
    res = train.run(small.train_context(), *small.config())
    first = {k: c for k, c in res.checks.items() if not k.startswith("window_")}
    assert all(c["value"] <= c["limit"] for c in first.values()), first
    assert not res.correct, res.checks


def test_train_batches():
    mix = common.read_json(common.HERE / "traffic" / "train_b32_400.json")
    mix = {**mix, "batches": 3}
    a = traffic.batches(mix, 2 ** 35 + 1, 80, 1025)
    b = traffic.batches(mix, 2 ** 35 + 1, 80, 1025)
    c = traffic.batches(mix, 9, 80, 1025)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    frames = {float(x["mel_lengths"].sum()) for x in a + c}
    assert len(frames) == 1                          # every step the same frames
    texts = {tuple(sorted(x["token_lengths"])) for x in a + c}
    assert len(texts) == 1
    x = a[0]
    assert x["mel"].shape == (32, 400, 80) and x["linear"].shape == (32, 400, 1025)
    assert x["mel_lengths"].min() > 200 and x["mel_lengths"].max() <= 400
    assert x["token_lengths"].min() > 32 and x["token_lengths"].max() <= 64
    row = int(np.argmin(x["mel_lengths"]))
    assert not x["mel"][row, x["mel_lengths"][row]:].any()
    assert (x["tokens"][row, x["token_lengths"][row]:] == 0).all()
    assert not np.array_equal(a[0]["mel"], a[1]["mel"])
