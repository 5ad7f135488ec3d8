"""The port's spans and counters (``utils/profiling.py``) on the CPU:

* with no profiler recording, ``span`` enters no ``record_function`` and
  costs under a microsecond;
* under ``profile_trace`` a ``Synthesizer`` call writes one ``gst.synth``
  ``user_annotation`` a call, numbered with the call's sequence number, with
  its stages nested under it; a ``train_step`` writes ``gst.train.step``
  with the forward, the losses, the backward and the optimizer in that
  order (also under ``StepWindowProfiler``, the trainer's tracer); a
  one-rank gloo ``DistributedSynthesizer`` call nests its own;
* outputs, losses and parameters are the same bits with and without a
  profiler recording;
* on the CPU nothing is copied from a card: ``d2h_bytes`` and
  ``host_syncs`` stay 0.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from gst_tacotron_tpu_torch.config import load_config
from gst_tacotron_tpu_torch.synthesize import Synthesizer
from gst_tacotron_tpu_torch.train import init_state, make_optimizer, train_step
from gst_tacotron_tpu_torch.utils import profiling
from gst_tacotron_tpu_torch.weights import build_model

from tests.test_torch_parallel_train import global_batch
from tests.torch_dist_workers import run_ranks

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden", "config.json")
TEXTS = ["the first sentence.", "third."]
STEPS = 4
# each stage and the span it nests in directly
SYNTH_TREE = {
    "gst.synth.frontend": "gst.synth", "gst.synth.ref_mels": "gst.synth",
    "gst.features.prep": "gst.synth.ref_mels", "gst.features.stft": "gst.synth.ref_mels",
    "gst.features.to_host": "gst.synth.ref_mels", "gst.synth.h2d": "gst.synth",
    "gst.synth.infer": "gst.synth", "gst.model.gst": "gst.synth.infer",
    "gst.model.encoder": "gst.synth.infer", "gst.model.decoder_ar_scan": "gst.synth.infer",
    "gst.model.postnet": "gst.synth.infer", "gst.synth.vocoder": "gst.synth.infer",
    "gst.synth.to_host": "gst.synth",
}
DSYNTH_TREE = {
    **{k: v for k, v in SYNTH_TREE.items() if v in ("gst.synth.ref_mels", "gst.synth.infer")},
    "gst.synth.frontend": "gst.dsynth", "gst.synth.ref_mels": "gst.dsynth",
    "gst.dsynth.local": "gst.dsynth", "gst.dsynth.gather": "gst.dsynth",
    "gst.dsynth.to_host": "gst.dsynth",
}
DSYNTH_TREE.update({k: "gst.dsynth.local" for k, v in DSYNTH_TREE.items()
                    if v == "gst.synth.infer"})


@pytest.fixture(scope="module")
def cfg():
    return load_config(GOLDEN)


def wavs(cfg):
    rng = np.random.default_rng(0)
    return [rng.uniform(-0.5, 0.5, n * cfg.audio.hop_length).astype(np.float32)
            for n in (20, 33)]


def user_annotations(log_dir):
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e["args"]) for e in events
            if e.get("cat") == "user_annotation" and e["name"].startswith("gst.")]


def parent_of(events, inner):
    """The innermost ``gst.*`` event that holds ``inner``."""
    name, s, e, _ = inner
    holders = [x for x in events if x is not inner and x[1] <= s and e <= x[2]
               and (x[1], -x[2]) < (s, -e)]
    return max(holders, key=lambda x: (x[1], -x[2]))[0] if holders else None


def assert_tree(events, tree, top):
    tops = [x for x in events if x[0] == top]
    assert tops
    for x in events:
        assert parent_of(events, x) == (None if x[0] == top else tree[x[0]]), x
    for t in tops:
        inside = {x[0] for x in events if t[1] <= x[1] and x[2] <= t[2]}
        assert inside == set(tree) | {top}


def test_span_without_a_profiler_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("gst.a") is profiling.span("gst.b", call=3)   # nothing allocated
    with profiling.span("gst.synth", call=profiling.next_call()):
        with profiling.span("gst.synth.infer"):
            pass
    n, span = 100_000, profiling.span
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            with span("gst.synth.infer"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 1e-6, f"{best * 1e9:.0f} ns a span"


def test_synthesis_spans_nest_and_carry_the_call(cfg, tmp_path):
    synth = Synthesizer(cfg, build_model(cfg, seed=0, device="cpu"), device="cpu")
    call = dict(reference_wavs=wavs(cfg), max_steps=STEPS, seed=5)
    synth(TEXTS, **call)                       # builds the extractor
    profiling.reset_counters()
    with profiling.profile_trace(str(tmp_path)):
        first = profiling.next_call() + 1
        traced = [synth(TEXTS, **call) for _ in range(2)]
    untraced = synth(TEXTS, **call)
    events = user_annotations(tmp_path)
    tops = sorted((x for x in events if x[0] == "gst.synth"), key=lambda x: x[1])
    assert [x[3]["call"] for x in tops] == [first, first + 1]
    assert all("call" not in x[3] for x in events if x[0] != "gst.synth")
    assert_tree(events, SYNTH_TREE, "gst.synth")
    for out in traced:
        assert out.keys() == untraced.keys()
        for k, v in untraced.items():
            np.testing.assert_array_equal(out[k], v, err_msg=k)
    # every call (and the number taken above) is counted; nothing copied
    assert profiling.counters()["calls"] == 4
    assert profiling.counters().get("d2h_bytes", 0) == 0
    assert profiling.counters().get("host_syncs", 0) == 0


def steps(cfg, batches, profiler=None):
    _, state = init_state(cfg, "cpu")
    tx = make_optimizer(cfg.optimizer)
    losses = []
    for b in batches:
        if profiler is not None:
            profiler.tick()
        losses.append({k: v.clone() for k, v in train_step(
            tx, cfg, state, {k: torch.from_numpy(v) for k, v in b.items()}).items()})
    if profiler is not None:
        profiler.stop()
    return losses, {k: v.clone() for k, v in state.model.state_dict().items()}


@pytest.mark.parametrize("tracer", ["profile_trace", "StepWindowProfiler"])
def test_train_step_spans_in_order_and_the_same_bits(cfg, tmp_path, tracer):
    rng = np.random.default_rng(1)
    batches = [global_batch(rng) for _ in range(3)]
    if tracer == "profile_trace":
        with profiling.profile_trace(str(tmp_path)):
            traced = steps(cfg, batches)
        n = 3
    else:
        traced = steps(cfg, batches, profiling.StepWindowProfiler(str(tmp_path), 1, 2))
        n = 2
    plain = steps(cfg, batches)
    for got, want in zip(traced[0], plain[0]):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for k in plain[1]:
        assert torch.equal(traced[1][k], plain[1][k]), k
    events = user_annotations(tmp_path)
    tops = sorted((x for x in events if x[0] == "gst.train.step"), key=lambda x: x[1])
    assert len(tops) == n
    calls = [x[3]["call"] for x in tops]
    assert calls == list(range(calls[0], calls[0] + n))
    for t in tops:
        stages = sorted((x for x in events if t[1] <= x[1] and x[2] <= t[2]
                         and parent_of(events, x) == "gst.train.step"), key=lambda x: x[1])
        assert [x[0] for x in stages] == ["gst.train.forward", "gst.train.loss",
                                          "gst.train.backward", "gst.train.optimizer"]
        inside = {x[0] for x in events if t[1] <= x[1] and x[2] <= t[2]}
        assert {"gst.model.encoder", "gst.model.gst", "gst.model.decoder_teacher_forced",
                "gst.model.postnet"} <= inside


def test_one_rank_distributed_synthesis_spans_nest(cfg, tmp_path):
    kwargs = dict(texts=TEXTS, reference_wavs=wavs(cfg), max_steps=STEPS, seed=5)
    [(events, counters)] = run_ranks("dsynth_spans", 1, cfg, kwargs, str(tmp_path))
    assert sum(x[0] == "gst.dsynth" for x in events) == 1
    assert [x[3]["call"] for x in events if x[0] == "gst.dsynth"] == [1]
    assert_tree(events, DSYNTH_TREE, "gst.dsynth")
    assert counters.get("d2h_bytes", 0) == 0 and counters.get("host_syncs", 0) == 0
