"""The trace reader on canned Chrome-trace events: merged device intervals,
kernel names attributed to the port's kernels, memcpys, NCCL and library
work, the idle gaps named by the host, and the lost-events guard."""

from __future__ import annotations

import importlib.util

import pytest

from benchmark import common, trace


def ev(name, ts, dur, cat="kernel", device=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": device,
            "args": {"device": device}}


EVENTS = [
    ev("decode_phase(Phase, Ctx)", 0, 10),
    ev("decode_scores(Prod, Ctx)", 5, 10),                 # overlaps: counted once
    ev("wavernn_sample_kernel(WaveArgs)", 40, 30),
    ev("Memcpy DtoH (Device -> Pageable)", 80, 5, cat="gpu_memcpy"),
    ev("ncclDevKernel_AllGather_RING_LL(ncclDevComm*)", 90, 4),
    ev("void at::native::elementwise_kernel<128, 4>(int)", 100, 20),
    ev("Memset (Device)", 120, 1, cat="gpu_memset"),
    ev("decode_attend(Ctx)", 200, 10, device=1),           # another card: not read
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 14, "dur": 30},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 86, "dur": 3},
]


def test_busy_is_the_union_of_device_intervals():
    s = trace.summarize(EVENTS, window_s=200e-6)
    # [0, 15] + [40, 70] + [80, 85] + [90, 94] + [100, 121]
    assert s["busy_s"] == pytest.approx((15 + 30 + 5 + 4 + 21) * 1e-6)
    assert s["window_s"] == 200e-6


def test_kernels_are_attributed_by_name():
    s = trace.summarize(EVENTS, window_s=1.0)
    cs, cn = s["class_s"], s["class_n"]
    assert cs["decode_scan"] == pytest.approx(20e-6) and cn["decode_scan"] == 2
    assert cs["wavernn_sample"] == pytest.approx(30e-6)
    assert cs["memcpy_DtoH"] == pytest.approx(5e-6)
    assert cs["nccl"] == pytest.approx(4e-6)
    assert cs["library"] == pytest.approx(20e-6)
    assert cn["memset"] == 1
    assert s["kernels"] == 5
    assert s["device_ops"][0][0].startswith("wavernn_sample_kernel")


@pytest.mark.parametrize("name,cls", [
    ("gru_recur_kernel(GruArgs)", "gru_scan"), ("gru_input_gemm(float const*)", "gru_scan"),
    ("refenc_bf16_kernel(Args)", "refenc_stack"), ("stft_bf16_wgmma_kernel(P)", "stft"),
    ("stft_wav_kernel(P)", "stft"), ("stft_frames_kernel(P)", "stft_frames"),
    ("decode_prep_weights(Prod, float const*, int, int)", "decode_scan"),
    ("decode_phaseX()", "library"), ("void decode_phase<3>(Phase, Ctx)", "decode_scan"),
    ("void refenc_layer_kernel<4, 2, true>(RefArgs)", "refenc_stack"),
    ("void stft_bf16_wgmma_kernel<true, false>(P)", "stft"), ("sm90_xmma_gemm_bf16bf16", "library"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy_HtoD"),
])
def test_classify(name, cls):
    assert trace.classify(name, "gpu_memcpy" if name.startswith("Memcpy") else "kernel") == cls


def test_idle_gaps_are_named_by_the_host_operation_across_them():
    s = trace.summarize(EVENTS, window_s=1.0)
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(25e-6)                 # 15 .. 40
    assert gaps["cudaStreamSynchronize"] == pytest.approx(5e-6)        # 85 .. 90
    assert gaps["python"] == pytest.approx(10e-6 + 6e-6)               # 70 .. 80, 94 .. 100


def test_guard_passes_a_whole_profile():
    s = trace.summarize(EVENTS, window_s=1.0)
    assert trace.check_complete(s, {"decode_scan": 1, "wavernn_sample": 1}) is None


def test_guard_fails_a_lost_launch():
    s = trace.summarize([e for e in EVENTS if not e["name"].startswith("wavernn")], 1.0)
    assert "wavernn_sample" in trace.check_complete(s, {"decode_scan": 1, "wavernn_sample": 1})


def test_guard_fails_no_device_time():
    s = trace.summarize([e for e in EVENTS if e["cat"] == "cpu_op"], 1.0)
    assert trace.check_complete(s, {}) == "no device time in the profile"


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "m", common.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_metric_readers():
    s = trace.summarize(EVENTS, window_s=150e-6)
    layer = {"trace": s, "traced_calls": 2, "chips": 1,
             "bounds": {"decode_scan": 4e-6, "wavernn_sample": 3e-6},
             "untraced": {"calls": 10, "wall_s": 2.0, "flops": 989e12}}
    assert _metric("idle_share.synth").read(layer) == pytest.approx(
        100 * (1 - 75e-6 / 150e-6))
    assert _metric("decode_scan_roofline").read(layer) == pytest.approx(100 * 8e-6 / 20e-6)
    assert _metric("wavernn_sample_roofline").read(layer) == pytest.approx(100 * 6e-6 / 30e-6)
    assert _metric("copy_ms.synth").read(layer) == pytest.approx(1e3 * 5e-6 / 2)
    assert _metric("library_ms.synth").read(layer) == pytest.approx(1e3 * 20e-6 / 2)
    assert _metric("mfu.synth").read(layer) == pytest.approx(50.0)


def test_a_reader_with_nothing_to_read_returns_nothing():
    layer = {"trace": trace.summarize(EVENTS[:1], 1.0), "traced_calls": 1, "chips": 1,
             "bounds": {"decode_scan": 1e-6}}
    assert _metric("wavernn_sample_roofline").read(layer) is None
    assert _metric("copy_ms.synth").read(layer) is None
    assert _metric("mfu.synth").read({"chips": 1}) is None


def test_profile_takes_a_lost_profile_once_more(monkeypatch, tmp_path):
    """A profile the guard fails is taken again; a second failure raises."""
    runs = []
    lost = [e for e in EVENTS if not e["name"].startswith("wavernn")]
    monkeypatch.setattr(trace, "capture", lambda fn, calls, path: runs.append(path) or 1.0)
    tables = iter([lost, EVENTS])
    monkeypatch.setattr(trace, "load", lambda path: next(tables))
    s = trace.profile(lambda: None, 1, str(tmp_path / "t.json"),
                      counted=lambda: {"wavernn_sample": 1})
    assert len(runs) == 2 and s["class_n"]["wavernn_sample"] == 1
    monkeypatch.setattr(trace, "load", lambda path: lost)
    with pytest.raises(RuntimeError, match="lost events twice"):
        trace.profile(lambda: None, 1, str(tmp_path / "t.json"),
                      counted=lambda: {"wavernn_sample": 1})
