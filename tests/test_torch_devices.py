"""Device rules of the port, for every kernel's wrapper (K4's location-
sensitive branch and K5 included): CPU tensors take the plain path and
launch no kernel; with no card and no device named, entry points raise; a tensor on
any other device raises instead of falling back; a failed launch raises and
is not counted; a build with no nvcc raises."""

from pathlib import Path

import numpy as np
import pytest
import torch

from gst_tacotron_tpu_torch import ops
from gst_tacotron_tpu_torch.config import AudioConfig, load_config
from gst_tacotron_tpu_torch.dsp.device_features import DeviceFeatureExtractor
from gst_tacotron_tpu_torch.config import AttentionConfig, DecoderConfig, VocoderConfig
from gst_tacotron_tpu_torch.models.decoder import DecoderCell
from gst_tacotron_tpu_torch.models.wavernn import WaveRNN
from gst_tacotron_tpu_torch.ops import build, decode, gru, refenc, stft, wavernn
from gst_tacotron_tpu_torch.synthesize import Synthesizer
from gst_tacotron_tpu_torch.weights import build_model, build_wavernn, init_weights

torch.set_num_threads(2)

GOLDEN_CFG = str(Path(__file__).resolve().parent / "fixtures" / "golden" / "config.json")


def _gru_args(device):
    g = torch.Generator().manual_seed(0)
    xs = torch.randn(2, 5, 3, generator=g)
    w = [torch.randn(3, 12, generator=g), torch.randn(12, generator=g),
         torch.randn(4, 12, generator=g), torch.randn(12, generator=g)]
    return [t.to(device) for t in [xs, torch.zeros(2, 4)] + w]


def _wavernn_args(device):
    model = WaveRNN(VocoderConfig(kind="wavernn", wavernn_gru_dim=8, wavernn_fc_dim=8,
                                  wavernn_bits=4, wavernn_hop=2), 5)
    init_weights(model, seed=0)
    model = model.to(device)
    with torch.no_grad():
        return model.pack(), model.cond_frames(torch.rand(2, 3, 5).to(device))


def _lsa_decode_args(device):
    dec = DecoderConfig(prenet_dims=(8, 4), attention_rnn_dim=8, decoder_rnn_dim=8,
                        reduction_factor=1)
    attn = AttentionConfig(kind="location_sensitive", dim=6, location_filters=3,
                           location_kernel_size=5)
    cell = DecoderCell(dec, attn, 4, 7)
    init_weights(cell, seed=0)
    cell = cell.to(device)
    memory = torch.rand(2, 5, 7).to(device)
    with torch.no_grad():
        keys = cell.precompute_keys(memory)
    return (cell.pack(), memory, keys, torch.tensor([5, 3], device=device)), \
        dict(dec_cfg=dec, attn_cfg=attn, num_mels=4, steps=3)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    ops.reset_launch_counts()
    args = _gru_args("cpu")
    lens = torch.tensor([5, 2])
    a = gru.gru_scan(*args, lengths=lens)
    b = gru.gru_scan_plain(*args, lengths=lens)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    mel = torch.rand(2, 16, 8)
    k = [torch.randn(3, 3, 1, 4), torch.randn(3, 3, 4, 4)]
    s, bb = [torch.ones(4)] * 2, [torch.zeros(4)] * 2
    assert torch.equal(refenc.refenc_stack(mel, k, s, bb),
                       refenc.refenc_stack_plain(mel, k, s, bb))
    cfg = AudioConfig(n_fft=512, hop_length=128, win_length=512)
    wav = torch.rand(2, 512 + 128 * 3)
    assert all(torch.equal(x, y) for x, y in zip(stft.stft_features(wav, cfg),
                                                  stft.stft_features_plain(wav, cfg)))
    packed, cond = _wavernn_args("cpu")
    assert torch.equal(wavernn.wavernn_sample(packed, cond, hop=2, seed=3),
                       wavernn.wavernn_sample_plain(packed, cond, hop=2, seed=3))
    args, kw = _lsa_decode_args("cpu")
    assert all(torch.equal(x, y) for x, y in zip(decode.decode_scan(*args, **kw),
                                                  decode.decode_scan_plain(*args, **kw)))
    scfg = load_config(GOLDEN_CFG)
    out = Synthesizer(scfg, build_model(scfg, seed=0, device="cpu"), device="cpu")(
        ["no kernels on the cpu."], reference_wavs=[np.zeros(3000, np.float32)], max_steps=2)
    assert np.all(np.isfinite(out["mel"]))
    assert all(k.launches == 0 for k in ops.all_kernels())
    assert not any(ops.launch_counts().values())


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(GOLDEN_CFG)
    model = build_model(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceFeatureExtractor(cfg.audio)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_wavernn(cfg, seed=0)
    with pytest.raises(RuntimeError, match="not available"):
        Synthesizer(cfg, model, device="cuda")


def test_other_devices_raise_instead_of_falling_back():
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        gru.gru_scan(*_gru_args("meta"))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        stft.stft_features(torch.zeros(1, 1024, device="meta"),
                           AudioConfig(n_fft=512, hop_length=128, win_length=512))
    packed, cond = _wavernn_args("meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        wavernn.wavernn_sample(packed, cond, hop=2)
    args, kw = _lsa_decode_args("meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        decode.decode_scan(*args, **kw)


def test_failed_launch_raises_and_is_not_counted():
    k = build.CudaKernel("gru_scan.cu", "gru_scan_launch", [])
    k._fn = lambda *args: 9
    k._err = lambda code: b"invalid configuration argument"
    with pytest.raises(RuntimeError, match="invalid configuration argument"):
        k()
    assert k.launches == 0
    k._fn = lambda *args: 0
    k()
    assert k.launches == 1


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.CudaKernel("gru_scan.cu", "gru_scan_launch", []).start_build()


def test_every_kernel_source_exists_with_its_note():
    for k in ops.all_kernels():
        src = (build.CSRC_DIR / k.source).read_text()
        assert "Replaces: gst_tacotron_tpu/ops/" in src
        assert "Bound on the H100" in src and "Design:" in src
        assert f'extern "C" int {k.symbol}(' in src
    assert [k.name for k in ops.all_kernels()] == [
        "gru_scan", "refenc_stack", "stft_features", "decode_scan", "wavernn_sample"]
    assert decode.KERNEL.library_path().name.startswith("decode_scan-")
