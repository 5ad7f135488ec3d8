"""The synthesis results on their way to the host (``device.HostCopies``,
``Synthesizer.to_host``).

On the CPU, at the golden config's small widths on the paths of gst_lj,
gst_r1_location, gst_wavernn and the chunked decoder: a ``Synthesizer``
call returns the keys, dtypes, shapes and values of a per-tensor
``.cpu().numpy()`` of the same outputs, with the same ``to_host`` on
outputs whose copies no one started (``DistributedSynthesizer``'s route),
and counts no copy from a card.

On the card (``cuda``-marked, skipped here), on the gst_lj and WaveRNN
paths: the arrays are pinned and bit-equal to ``.cpu().numpy()`` of the
device outputs; a later call leaves an earlier call's arrays alone; a
source freed and its memory written over while its copy waits still
arrives whole; the copies started before the vocoder are every output
but the waveform, and the host waits once for the result. No JAX here:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_to_host.py -q
"""

import os

import numpy as np
import pytest
import torch

from gst_tacotron_tpu_torch import device as device_mod
from gst_tacotron_tpu_torch.config import apply_overrides, load_config
from gst_tacotron_tpu_torch.device import HostCopies
from gst_tacotron_tpu_torch.models.attention import alignment_diagonality
from gst_tacotron_tpu_torch.synthesize import Synthesizer
from gst_tacotron_tpu_torch.utils.profiling import counters
from gst_tacotron_tpu_torch.vocoder import WaveRNNVocoder
from gst_tacotron_tpu_torch.weights import build_model, build_wavernn

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden", "config.json")
TEXTS = ["the first sentence.", "a second one.", "third."]
PATHS = {
    "gst_lj": {},
    "gst_r1_location": {"model.attention.kind": "location_sensitive",
                        "model.attention.location_filters": 4,
                        "model.attention.location_kernel_size": 7,
                        "model.decoder.reduction_factor": 1},
    "gst_wavernn": {"model.vocoder.kind": "wavernn", "model.vocoder.wavernn_hop": 128,
                    "model.vocoder.wavernn_gru_dim": 16, "model.vocoder.wavernn_fc_dim": 16},
    "chunked": {},
}
COUNTERS = ("d2h_bytes", "host_syncs", "d2h_early_bytes")


def make_synth(name, dev):
    cfg = apply_overrides(load_config(GOLDEN), PATHS[name])
    vocoder = None
    if cfg.model.vocoder.kind == "wavernn":
        vocoder = WaveRNNVocoder(cfg, build_wavernn(cfg, seed=1, device=dev), device=dev)
    return Synthesizer(cfg, build_model(cfg, seed=0, device=dev), device=dev,
                       vocoder=vocoder, use_chunked_decoder=name == "chunked", chunk_steps=4)


def style_wavs(cfg):
    rng = np.random.default_rng(0)
    return [rng.uniform(-0.5, 0.5, n * cfg.audio.hop_length).astype(np.float32)
            for n in (20, 33, 41)]


def device_outputs(synth, texts, wavs, seed, max_steps=6):
    """The call's outputs on the device, as ``__call__`` makes them (the
    same inputs and seed), and the token lengths."""
    host = synth.text_inputs(texts, True)
    ref_mel, ref_lengths = synth._reference_mels(wavs)
    tok, tok_len = (torch.from_numpy(host[k]).to(synth.device)
                    for k in ("tokens", "token_lengths"))
    out = synth.infer(tok, tok_len, ref_mel, ref_lengths, None, None, max_steps=max_steps,
                      seed=seed, deterministic_prenet=synth.deterministic_prenet,
                      chunk_steps=synth.chunk_steps)
    return out, tok_len


def per_tensor(synth, out, tok_len):
    """Each output copied on its own, as ``to_host`` copied them before the
    copies were started early: ``.cpu().numpy()`` of the float32 value."""
    r = synth.cfg.model.decoder.reduction_factor
    out = dict(out, diagonality=alignment_diagonality(
        out["alignments"], tok_len, torch.clamp(out["frame_lengths"] // r, min=1)))
    result = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
              if torch.is_tensor(v) else v for k, v in out.items()}
    result["wav_lengths"] = result["frame_lengths"] * synth.cfg.audio.hop_length
    return result


def assert_same_result(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def deltas(before):
    now = counters()
    return {k: now.get(k, 0) - before.get(k, 0) for k in COUNTERS}


@pytest.mark.parametrize("name", list(PATHS))
def test_call_returns_the_per_tensor_copies(name):
    """A call on the CPU: the same keys in the same order, dtypes, shapes
    and values as each output's ``.cpu().numpy()``; no copy from a card is
    counted."""
    synth = make_synth(name, "cpu")
    wavs = style_wavs(synth.cfg)
    want = per_tensor(synth, *device_outputs(synth, TEXTS, wavs, seed=3))
    before = counters()
    got = synth(TEXTS, reference_wavs=wavs, max_steps=6, seed=3)
    assert deltas(before) == dict.fromkeys(COUNTERS, 0)
    assert_same_result(got, want)
    assert got["wav"].dtype == np.float32 and got["frame_lengths"].dtype == np.int64
    if name == "chunked":
        assert isinstance(got["chunks_run"], int)


@pytest.mark.parametrize("name", list(PATHS))
def test_to_host_copies_outputs_no_one_started(name):
    """``to_host`` on ``infer``'s outputs, with no copy started (the route
    of ``DistributedSynthesizer``), gives the call's result."""
    synth = make_synth(name, "cpu")
    wavs = style_wavs(synth.cfg)
    out, tok_len = device_outputs(synth, TEXTS, wavs, seed=4)
    want = per_tensor(synth, out, tok_len)
    before = counters()
    assert_same_result(synth.to_host(out, tok_len), want)
    assert deltas(before) == dict.fromkeys(COUNTERS, 0)
    assert_same_result(synth(TEXTS, reference_wavs=wavs, max_steps=6, seed=4), want)


def test_host_copies_of_cpu_tensors_share_their_memory():
    """On the CPU a started copy is the tensor's own memory
    (``t.cpu().numpy()``, as ``to_numpy``), and ``wait`` blocks on
    nothing."""
    t = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.tensor([1, 2], dtype=torch.int64)}
    copies = HostCopies()
    before = counters()
    assert copies.start(t) == 0
    assert "a" in copies and "c" not in copies
    arrays = copies.wait()
    assert deltas(before) == dict.fromkeys(COUNTERS, 0)
    assert np.shares_memory(arrays["a"], t["a"].numpy())
    np.testing.assert_array_equal(device_mod.to_numpy(t["b"]), [1, 2])


@pytest.mark.parametrize("counted,want", [
    ({}, None),
    ({"d2h_bytes": 100, "calls": 1}, None),        # a program without the counter
    ({"d2h_early_bytes": 0, "calls": 1}, None),    # nothing copied from a card
    ({"d2h_bytes": 400, "d2h_early_bytes": 256, "calls": 2}, 64.0),
])
def test_early_share_reader(counted, want):
    """The benchmark's ``d2h_early_share.synth``: 100 x ``d2h_early_bytes``
    / ``d2h_bytes``, and nothing where the program counts no early copy."""
    from benchmark import run

    assert run.load_metric("d2h_early_share.synth").read({"counters": counted}) == want


# -- on the card ----------------------------------------------------------------

CARD_PATHS = ["gst_lj", "gst_wavernn"]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the copies run on a card's copy stream")
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.ops.build import build_all

    build_all(ops.all_kernels())
    return torch.device("cuda", 0)


def captured_call(synth, monkeypatch, **kw):
    """A call's result and ``.cpu().numpy()`` of its device outputs, taken
    after ``to_host`` returned."""
    real, seen = Synthesizer.to_host, {}

    def to_host(self, out, tok_len):
        result = real(self, out, tok_len)
        seen.update(out)
        return result

    monkeypatch.setattr(Synthesizer, "to_host", to_host)
    result = synth(TEXTS, **kw)
    monkeypatch.setattr(Synthesizer, "to_host", real)
    want = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
            for k, v in seen.items() if torch.is_tensor(v)}
    return result, want


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_PATHS)
def test_card_results_are_pinned_and_bit_equal(card, name, monkeypatch):
    synth = make_synth(name, card)
    wavs = style_wavs(synth.cfg)
    synth(TEXTS, reference_wavs=wavs, max_steps=6, seed=1)          # builds, warms
    got, want = captured_call(synth, monkeypatch, reference_wavs=wavs, max_steps=6, seed=2)
    assert set(want) | {"wav_lengths"} == set(got) - {"chunks_run"}
    for k, v in want.items():
        assert torch.from_numpy(got[k]).is_pinned(), k
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_PATHS)
def test_card_arrays_outlive_later_calls(card, name):
    """The arrays of one call are unchanged after a second and a third call
    (each call copies into pinned blocks of its own)."""
    synth = make_synth(name, card)
    wavs = style_wavs(synth.cfg)
    first = synth(TEXTS, reference_wavs=wavs, max_steps=6, seed=1)
    kept = {k: np.copy(v) for k, v in first.items() if isinstance(v, np.ndarray)}
    for seed in (2, 3):
        synth(TEXTS[::-1], reference_wavs=wavs[::-1], max_steps=6, seed=seed)
    torch.cuda.synchronize()
    for k, v in kept.items():
        np.testing.assert_array_equal(first[k], v, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_PATHS)
def test_card_sources_freed_and_overwritten_while_copies_wait(card, name):
    """The copy stream is held back (a ``_sleep`` kernel on it), the copies
    are started, every source is freed and its size allocated again and
    filled with NaN on the current stream: the arrays are the sources'
    values all the same, since each source stays reserved for its copy."""
    synth = make_synth(name, card)
    out, _ = device_outputs(synth, TEXTS, style_wavs(synth.cfg), seed=5)
    torch.cuda.synchronize()
    want = {k: v.cpu().numpy() for k, v in out.items() if torch.is_tensor(v)}
    shapes = {k: (v.shape, v.dtype) for k, v in out.items() if torch.is_tensor(v)}
    stream = device_mod._copy_stream(card)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(200_000_000)
    copies = HostCopies()
    copies.start({k: v for k, v in out.items() if torch.is_tensor(v)})
    del out
    fill = [torch.full(shape, float("nan") if dtype.is_floating_point else -7,
                       dtype=dtype, device=card) for shape, dtype in shapes.values()]
    arrays = copies.wait()
    del fill
    for k, v in want.items():
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_PATHS)
def test_card_early_copies_and_one_wait(card, name):
    """With token weights (no style wavs, so no extractor copy): the bytes
    started before the vocoder are every host array's but the waveform's,
    ``d2h_bytes`` all of them, and the host waits once."""
    synth = make_synth(name, card)
    weights = np.full((len(TEXTS), synth.cfg.model.gst.num_tokens), 0.1, np.float32)
    synth(TEXTS, token_weights=weights, max_steps=6, seed=1)
    before = counters()
    got = synth(TEXTS, token_weights=weights, max_steps=6, seed=2)
    arrays = {k: v.nbytes for k, v in got.items()
              if isinstance(v, np.ndarray) and k != "wav_lengths"}
    assert deltas(before) == {"d2h_bytes": sum(arrays.values()), "host_syncs": 1,
                              "d2h_early_bytes": sum(arrays.values()) - arrays["wav"]}
