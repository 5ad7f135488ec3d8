"""The gst_r1_location.synth cell on the CPU at small widths: configuration
3 (r=1, location-sensitive attention with its published 32 filters of 31
taps) through `drivers/synth.py`, judged by the reference; the judge
seeing the location term; the frozen decode counts at the cell's shapes;
and ``decode_step_us.synth``'s reader."""

from __future__ import annotations

import pytest
import torch

import small
from benchmark import common, run, work
from benchmark.drivers import synth

torch.set_num_threads(2)

CELL = "gst_r1_location.synth"


def test_sound_run_is_correct():
    cfg, spec = small.config("gst_r1_location")
    assert cfg.model.attention.kind == "location_sensitive"
    assert cfg.model.decoder.reduction_factor == 1
    res = synth.run(small.context(CELL, seconds=0.2), cfg, spec)
    assert res.correct, res.checks
    assert res.attempted >= 1 and res.failed == 0
    limits = common.read_json(common.HERE / "workloads" / f"{CELL}.json")["limits"]
    assert {k: c["limit"] for k, c in res.checks.items()} == limits
    assert res.metrics["audio_s_per_s"] > 0 and res.metrics["setup_s"] > 0


@pytest.mark.parametrize("name", ["decoder.cell.attention.location_conv.kernel",
                                  "decoder.cell.attention.location_proj.kernel"])
def test_location_weights_zeroed_are_not_correct(monkeypatch, name):
    """A decode that leaves out the location term: the program's copy of
    the location filters (or their projection) zeroed, the reference's
    the seed's."""
    real = synth.build

    def build(cfg, seed, dev):
        s, w, vw = real(cfg, seed, dev)
        with torch.no_grad():
            s.model.state_dict()[name].zero_()
        return s, w, vw

    monkeypatch.setattr(synth, "build", build)
    res = synth.run(small.context(CELL, seconds=0.1), *small.config("gst_r1_location"))
    assert not res.correct
    assert res.checks["align"]["value"] > res.checks["align"]["limit"]


def test_decode_counts_at_the_cell_shapes():
    from gst_tacotron_tpu_torch import kernel_bench as kb

    cfg, spec = common.load_config(common.read_json(
        common.HERE / "workloads" / f"{CELL}.json")["config"])
    cd = spec["config"]
    b, t, steps = 32, 192, cfg.model.decoder.max_decode_steps
    assert steps == 1000
    for dense in (False, True):
        assert work.decode_step_flops(cd, b, t, dense) == kb.decode_step_flops(cfg, b, t, dense)
    n = work.decode_weights(cd)
    assert work.decode_scan_work(cd, b, t, steps, n) == tuple(kb.decode_scan_work(
        cfg, b, t, steps, n))


def test_decode_step_us_reader():
    read = run.load_metric("decode_step_us.synth").read
    # 8 profiled calls, 0.4 s of K4; 10 calls decoded 10,000 steps in all
    layer = {"trace": {"class_s": {"decode_scan": 0.4}}, "traced_calls": 8,
             "counters": {"calls": 10, "decode_steps": 10_000}}
    assert read(layer) == pytest.approx(50.0)
    assert read({**layer, "counters": {"calls": 10}}) is None
    assert read({**layer, "trace": {"class_s": {}}}) is None
