"""The port's kernel microbenchmark (``gst_tacotron_tpu_torch/kernel_bench.py``,
the counterpart of ``tools/tpu_kernel_bench.py``): its decode FLOP count
against the JAX tool's own function, the roofline fields, the peaks lookup,
the work counts at the main path's shapes (the bounds of ``PERF.md`` §6's
kernel table), a ``--device cpu --quick`` report, and
the refusal to run without a card."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gst_tacotron_tpu.config import get_preset as jget_preset
from gst_tacotron_tpu_torch import kernel_bench as kb
from gst_tacotron_tpu_torch.config import get_preset
from gst_tacotron_tpu_torch.dsp.ref import live_tap_span

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_tool():
    """tools/tpu_kernel_bench.py as a module: its top level imports no JAX."""
    spec = importlib.util.spec_from_file_location("tpu_kernel_bench",
                                                  ROOT / "tools" / "tpu_kernel_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("preset", ["gst_lj", "gst_r1_location"])
@pytest.mark.parametrize("dense_band", [False, True])
@pytest.mark.parametrize("batch,t_mem", [(8, 64), (8, 128), (32, 64), (3, 17)])
def test_decode_step_flops_matches_the_jax_tool(jax_tool, preset, dense_band, batch, t_mem):
    assert kb.decode_step_flops(get_preset(preset), batch, t_mem, dense_band) == \
        jax_tool.decode_step_flops(jget_preset(preset), batch, t_mem, dense_band)


def test_roofline_fields():
    work = kb.Work(flops=2e9, bytes=1e6)          # 29.9 us of float32 operations
    r = kb.roofline("k", work, 100e-6, kb.H100)
    assert r["kernel"] == "k" and r["rate"] == "f32" and r["bound"] == "operations"
    assert r["wall_us"] == pytest.approx(100.0)
    assert r["achieved_tflops"] == pytest.approx(20.0)
    assert r["achieved_gbps"] == pytest.approx(10.0)
    assert r["arithmetic_intensity"] == pytest.approx(2000.0)
    assert r["speed_of_light_us"] == pytest.approx(2e9 / 67e12 * 1e6)
    assert r["fraction_of_sol"] == pytest.approx(2e9 / 67e12 / 100e-6)
    assert r["pct_peak"] == pytest.approx(100 * 20 / 67)
    assert r["pct_hbm_peak"] == pytest.approx(100 * 10 / 3350)
    # bytes-bound, and on the bf16 rate
    r16 = kb.roofline("k", kb.Work(1e9, 1e8, "bf16"), 1e-3, kb.H100)
    assert r16["bound"] == "bytes"
    assert r16["speed_of_light_us"] == pytest.approx(1e8 / 3.35e12 * 1e6)
    assert r16["pct_peak"] == pytest.approx(100 * 1.0 / 989)
    # no peaks (a CPU run, an unknown card): no share of the least time
    assert not {"bound", "fraction_of_sol", "speed_of_light_us"} & kb.roofline(
        "k", work, 1e-3, None).keys()


def test_card_peaks():
    h100 = kb.card_peaks("NVIDIA H100 80GB HBM3")
    assert (h100["bf16_tflops"], h100["tf32_tflops"], h100["f32_tflops"], h100["hbm_gbps"]) \
        == (989.0, 495.0, 67.0, 3350.0)
    other = kb.card_peaks("NVIDIA A100-SXM4-80GB")
    assert other["hbm_gbps"] is None and "achieved numbers only" in other["note"]
    assert kb.bound(kb.Work(67e9, 0.0)) == (pytest.approx(1.0), "operations")
    assert kb.bound(kb.Work(0.0, 3.35e9)) == (pytest.approx(1.0), "bytes")


def test_work_counts_give_the_kernel_lines_bounds():
    """At the main path's shapes (B=32, 64 tokens, 128 reference frames) the
    counts give the bounds that PERF.md §6's kernel table records
    (the packed weight counts are the configs' own: 2004864 gst_lj, 2020480
    gst_r1_location, 2100992 for gst_wavernn's vocoder)."""
    b = 32
    cfg = get_preset("gst_lj")
    a = cfg.audio
    k1 = [kb.gru_scan_work(b, t, d, 128, n) for t, d, n in ((64, 128, 2), (400, 128, 2),
                                                            (2, 256, 1))]
    k1 = kb.Work(sum(w.flops for w in k1), sum(w.bytes for w in k1))
    wav_bytes = 4.0 * b * (127 * a.hop_length + a.n_fft)
    n_live = live_tap_span(a)[2]
    r1 = get_preset("gst_r1_location")
    cases = {
        "K1": (k1, 0.0874, "operations"),
        "K2": (kb.refenc_stack_work(b, 128, 80, cfg.model.gst.ref_conv_channels), 0.0120,
               "operations"),
        "K3": (kb.stft_work(a, b * 128, wav_bytes), 0.00673, "bytes"),
        "K3''": (kb.stft_work(a, b * 128, 4.0 * b * 128 * n_live), 0.0104, "bytes"),
        "K3' bf16": (kb.stft_bf16_work(a, b * 128, wav_bytes), 0.0174, "operations"),
        "K4": (kb.decode_scan_work(cfg, b, 64, 200, 2004864), 0.375, "operations"),
        "K4-LSA": (kb.decode_scan_work(r1, b, 64, r1.model.decoder.max_decode_steps,
                                       2020480), 2.787, "operations"),
        "K5": (kb.wavernn_sample_work(get_preset("gst_wavernn"), b, 128, 512, 2100992),
               61.54, "operations"),
        "K5 hoisted": (kb.wavernn_sample_work(get_preset("gst_wavernn"), b, 128, 512, 2100992,
                                              hoisted=True), 37.03, "operations"),
    }
    for name, (work, ms, by) in cases.items():
        got = kb.bound(work)
        assert got[1] == by, name
        assert got[0] == pytest.approx(ms, rel=5e-3), name   # PERF.md: 3-4 digits
    # K2's bf16 mode: the same work at the tensor cores' rate
    w16 = kb.refenc_stack_work(b, 128, 80, cfg.model.gst.ref_conv_channels, bf16=True)
    assert w16.rate == "bf16" and w16.flops == cases["K2"][0].flops
    # the LSA views: the full band counts T - 31 more taps a position
    assert kb.decode_scan_work(r1, 8, 64, 10, 0, False).flops > \
        kb.decode_scan_work(r1, 8, 64, 10, 0, True).flops


def test_quick_cpu_report(tmp_path):
    out = tmp_path / "kb.json"
    kb.main(["--device", "cpu", "--quick", "--out", str(out)])
    r = json.loads(out.read_text())
    assert r["device"] == "cpu" and r["card"] is None and r["card_peaks"] is None
    assert set(r["sections"]) == {"decode", "stft_frames", "stft_routes", "refenc",
                                  "lsa_decode", "lstm_decode", "wavernn", "griffin_lim"}
    # the CPU runs the plain versions: no kernel launches
    assert all(s["launches"] == {} for s in r["sections"].values())
    for key in ("kernel_decode_ms", "plain_decode_ms", "bahdanau_marginal",
                "kernel_stft_ms_1024frames", "stft_paths_ms", "stft_marginal_us",
                "ref_encoder_marginal_us", "ref_encoder_floor_analysis",
                "kernel_lsa_decode_ms", "kernel_lstm_decode_ms", "wavernn_scaling",
                "griffin_lim_plain_ms", "griffin_lim_parity_l2"):
        assert key in r, key
    assert {c["section"] for c in r["checks"]} == set(r["sections"])
    assert all(c["max_err"] <= c["tol"] for c in r["checks"])
    assert r["roofline"] and all("fraction_of_sol" not in x and "bound" not in x
                                 for x in r["roofline"])
    assert "true_memory_floor_us" not in r["ref_encoder_floor_analysis"]
    assert r["failures"] == []


def test_refuses_to_run_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "-m", "gst_tacotron_tpu_torch.kernel_bench",
                        "--quick"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert "CUDA is not available" in p.stderr
    assert p.stdout == ""
