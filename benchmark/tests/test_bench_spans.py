"""The spans reader on a hand-built trace (nested spans, kernels matched to
their launches by correlation, idle gaps under spans and between them, a
second thread), the readers of the metrics it feeds, which cells read them,
how a reader finds a run's trace and counters (and reads None from a
program without them), and a traced run of the synthesis and train drivers
on the CPU."""

from __future__ import annotations

import json
import os

import pytest
import torch

import small
from benchmark import common, run, spans, trace
from benchmark.drivers import synth as synth_driver
from benchmark.drivers import train as train_driver

torch.set_num_threads(2)


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid, "args": {}}


def launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1,
            "pid": 7, "tid": tid, "args": {"correlation": corr}}


def device(name, ts, dur, corr, cat="kernel", dev=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": dev,
            "tid": 9, "args": {"device": dev, "correlation": corr}}


# two calls of thread 1 (µs): [0, 100) and [110, 150), nothing between them
EVENTS = [
    span("gst.synth", 0, 100), span("gst.synth.frontend", 0, 10),
    span("gst.synth.ref_mels", 10, 20), span("gst.features.stft", 12, 8),
    span("gst.synth.infer", 30, 50), span("gst.synth.vocoder", 60, 15),
    span("gst.synth.to_host", 80, 18),
    span("gst.synth", 110, 40), span("gst.synth.infer", 110, 30),
    span("gst.other", 5, 20, tid=2),                    # another thread: not read
    launch(15, 1), launch(35, 2), launch(65, 3), launch(85, 4, name="cudaMemcpyAsync"),
    launch(20, 5, tid=2),
    device("stft_wav_kernel(P)", 16, 10, 1), device("decode_phase(P)", 36, 20, 2),
    device("gemm", 66, 24, 3), device("Memcpy DtoH", 90, 5, 4, cat="gpu_memcpy"),
    device("other_thread_kernel", 120, 5, 5),           # busy, launched by thread 2
    device("on_card_1", 40, 50, 6, dev=1),              # another card: not read
]


def test_spans_nest_and_place_idle_and_device_time():
    s = spans.summarize(EVENTS)
    us = lambda x: pytest.approx(x * 1e-6, abs=1e-12)
    assert s["calls"] == 2
    assert s["window_s"] == us(150)
    # busy on card 0: [16, 26) [36, 56) [66, 95) [120, 125)
    assert s["idle_s"] == us(150 - 64)
    assert s["unspanned_idle_s"] == us(10)
    r = s["spans"]
    assert set(r) == {"gst.synth", "gst.synth.frontend", "gst.synth.ref_mels",
                      "gst.features.stft", "gst.synth.infer", "gst.synth.vocoder",
                      "gst.synth.to_host"}
    assert r["gst.synth"]["count"] == 2 and r["gst.synth.infer"]["count"] == 2
    assert r["gst.synth"]["wall_s"] == us(140) and r["gst.synth"]["self_s"] == us(12)
    assert r["gst.synth.ref_mels"]["self_s"] == us(12)
    assert r["gst.synth.infer"]["wall_s"] == us(80) and r["gst.synth.infer"]["self_s"] == us(65)
    innermost = {"gst.synth": 12, "gst.synth.frontend": 10, "gst.synth.ref_mels": 6,
                 "gst.features.stft": 4, "gst.synth.infer": 35, "gst.synth.vocoder": 6,
                 "gst.synth.to_host": 3}
    for name, idle in innermost.items():
        assert r[name]["idle_s"] == us(idle), name
    assert sum(innermost.values()) + 10 == 150 - 64
    assert r["gst.synth.infer"]["idle_in_s"] == us(41)
    assert r["gst.synth.ref_mels"]["idle_in_s"] == us(10)
    assert r["gst.synth"]["idle_in_s"] == us(76)
    device_s = {"gst.synth": (59, 4), "gst.synth.ref_mels": (10, 1),
                "gst.features.stft": (10, 1), "gst.synth.infer": (44, 2),
                "gst.synth.vocoder": (24, 1), "gst.synth.to_host": (5, 1),
                "gst.synth.frontend": (0, 0)}
    for name, (t, n) in device_s.items():
        assert r[name]["device_s"] == us(t) and r[name]["launches"] == n, name


def test_a_trace_without_spans_gives_none():
    assert spans.summarize([e for e in EVENTS if e["cat"] != "user_annotation"]) is None


TRAIN_EVENTS = [span("gst.train.step", 0, 100), span("gst.train.forward", 0, 40),
                span("gst.model.encoder", 2, 10), span("gst.train.loss", 40, 5),
                span("gst.train.backward", 45, 35), span("gst.train.optimizer", 80, 19),
                span("gst.train.step", 200, 80), span("gst.train.forward", 200, 30),
                span("gst.train.loss", 230, 5), span("gst.train.backward", 235, 25),
                span("gst.train.optimizer", 260, 15)]


def layer_with_spans():
    return {"spans": spans.summarize(EVENTS), "counters": {"d2h_bytes": 3_000_000,
                                                           "host_syncs": 12, "calls": 2}}


@pytest.mark.parametrize("metric,layer,want", [
    ("frontend_idle_ms.synth", layer_with_spans, (10 + 6 + 4) / 2 * 1e-3),
    ("model_idle_ms.synth", layer_with_spans, 41 / 2 * 1e-3),
    ("to_host_idle_ms.synth", layer_with_spans, 3 / 2 * 1e-3),
    ("vocoder_ms.synth", layer_with_spans, 24 / 2 * 1e-3),
    ("d2h_mb.synth", layer_with_spans, 1.5),
    ("forward_ms.train", lambda: {"spans": spans.summarize(TRAIN_EVENTS)}, 35e-3),
    ("backward_ms.train", lambda: {"spans": spans.summarize(TRAIN_EVENTS)}, 30e-3),
    ("optimizer_ms.train", lambda: {"spans": spans.summarize(TRAIN_EVENTS)}, 17e-3),
])
def test_readers(metric, layer, want):
    read = run.load_metric(metric).read
    assert read({}) is None
    assert read({"spans": None, "counters": {}}) is None
    assert read(layer()) == pytest.approx(want, rel=1e-9)


NEW = {"frontend_idle_ms.synth", "model_idle_ms.synth", "to_host_idle_ms.synth",
       "vocoder_ms.synth", "d2h_mb.synth", "forward_ms.train", "backward_ms.train",
       "optimizer_ms.train"}


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  common.read_json(common.ROOT / "BENCHMARK.json")["workloads"]])
def test_each_metric_is_read_only_in_its_cells(cell):
    bench = common.read_json(common.ROOT / "BENCHMARK.json")
    layer = layer_with_spans()
    layer["spans"]["spans"].update(spans.summarize(TRAIN_EVENTS)["spans"])
    got = set(run.per_layer(bench, cell, layer)) & NEW
    want = {m["name"] for m in bench["per_layer"] if m["name"] in NEW and cell in m["workloads"]}
    assert got == want
    assert NEW <= {m["name"] for m in bench["per_layer"]}


def write_trace(path, events):
    path.write_text(json.dumps({"traceEvents": events}))


def test_a_run_reads_the_trace_its_driver_wrote_last(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "OUT_DIR", tmp_path)
    write_trace(tmp_path / "a.trace.json", TRAIN_EVENTS)
    os.utime(tmp_path / "a.trace.json", (common.process_start(),) * 2)
    old = tmp_path / "b.trace.json"
    write_trace(old, [])
    os.utime(old, (0, 0))                       # before this process began
    traced = {"trace": {}}
    assert spans.of_run({}) is None             # the driver took no profile
    assert spans.of_run(traced)["spans"].keys() == spans.summarize(TRAIN_EVENTS)["spans"].keys()
    write_trace(tmp_path / "c.trace.json", EVENTS)
    assert spans.of_run(traced) == spans.summarize(EVENTS)
    assert run.load_metric("to_host_idle_ms.synth").read(traced) == pytest.approx(1.5e-3)
    # a program that marks no span: its trace gives every reader None
    write_trace(tmp_path / "c.trace.json", [e for e in EVENTS if e["cat"] != "user_annotation"])
    assert spans.of_run(traced) is None
    assert all(run.load_metric(m).read(traced) is None for m in NEW - {"d2h_mb.synth"})


def test_a_run_reads_the_programs_counters(monkeypatch):
    from gst_tacotron_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_counters", {"d2h_bytes": 9_000_000, "calls": 3})
    read = run.load_metric("d2h_mb.synth").read
    assert spans.counters_of_run({}) is None
    assert read({"trace": {}}) == pytest.approx(3.0)
    # a program without counters
    monkeypatch.delattr(profiling, "counters")
    assert spans.counters_of_run({"trace": {}}) is None and read({"trace": {}}) is None


@pytest.fixture
def cpu_trace(monkeypatch, tmp_path):
    """``trace.profile`` on the CPU: no card to synchronize, none whose
    device time the guard could find; traces written under ``tmp_path``."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(trace, "check_complete", lambda summary, launches: None)
    monkeypatch.setattr(common, "OUT_DIR", tmp_path)


def test_traced_synthesis_run_reads_its_spans(cpu_trace):
    ctx = small.context(seconds=0.1, trace_calls=2)
    ctx.trace = True
    res = synth_driver.run(ctx, *small.config())
    s = spans.of_run(res.layer)
    assert s["calls"] == 2
    for name in ("gst.synth", "gst.synth.frontend", "gst.synth.ref_mels", "gst.features.prep",
                 "gst.features.stft", "gst.features.to_host", "gst.synth.h2d",
                 "gst.synth.infer", "gst.model.gst", "gst.model.encoder",
                 "gst.model.decoder_ar_scan", "gst.model.postnet", "gst.synth.vocoder",
                 "gst.synth.to_host"):
        assert s["spans"][name]["count"] >= 2, name
    # no card: every moment of the window is idle, and nearly all of it spanned
    assert s["idle_s"] == pytest.approx(s["window_s"])
    assert s["unspanned_idle_s"] < 0.05 * s["idle_s"]
    assert spans.counters_of_run(res.layer).get("d2h_bytes", 0) == 0
    bench = common.read_json(common.ROOT / "BENCHMARK.json")
    line = run.result_line(bench, ctx.cell, res, True)
    for m in ("frontend_idle_ms.synth", "model_idle_ms.synth", "to_host_idle_ms.synth"):
        assert line["metrics"][m]["value"] > 0, m
    # no card: Griffin-Lim launches nothing, and nothing is copied from one
    assert line["metrics"]["vocoder_ms.synth"]["value"] == 0.0
    assert "d2h_mb.synth" not in line["metrics"]


def test_traced_train_run_reads_its_spans(cpu_trace):
    ctx = small.train_context(seconds=0.1)
    ctx.trace = True
    res = train_driver.run(ctx, *small.config())
    s = spans.of_run(res.layer)
    assert s["calls"] == ctx.workload["trace_steps"]
    bench = common.read_json(common.ROOT / "BENCHMARK.json")
    line = run.result_line(bench, ctx.cell, res, True)
    for m in ("forward_ms.train", "backward_ms.train", "optimizer_ms.train"):
        assert line["metrics"][m]["value"] > 0, m
