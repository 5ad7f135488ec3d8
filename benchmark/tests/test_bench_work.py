"""The yardstick's frozen work counts and peaks equal the program's kernel
bench at each cell's shapes, so drift on either side shows."""

from __future__ import annotations

import pytest

from gst_tacotron_tpu_torch import kernel_bench as kb

from benchmark import common, work

SHAPES = {  # cell: (batch, padded text, style frames)
    "gst_lj.synth": (32, 192, 576), "gst_wavernn.synth": (32, 192, 576)}


def _cfg(cell):
    return common.load_config(common.read_json(
        common.HERE / "workloads" / f"{cell}.json")["config"])


def test_peaks():
    assert work.CARD_PEAKS == kb.CARD_PEAKS
    assert work.MFU_PEAK_FLOPS == 989e12


@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_decode_counts(cell):
    cfg, spec = _cfg(cell)
    cd = spec["config"]
    b, t, _ = SHAPES[cell]
    steps = cfg.model.decoder.max_decode_steps
    for dense in (False, True):
        assert work.decode_step_flops(cd, b, t, dense) == kb.decode_step_flops(cfg, b, t, dense)
    n = work.decode_weights(cd)
    assert work.decode_scan_work(cd, b, t, steps, n) == tuple(kb.decode_scan_work(
        cfg, b, t, steps, n))


def test_decode_weights_count_the_packed_operands():
    import torch

    from gst_tacotron_tpu_torch.models.tacotron import GSTTacotron
    from gst_tacotron_tpu_torch.text import NUM_SYMBOLS

    cfg, spec = _cfg("gst_lj.synth")
    with torch.device("meta"):
        model = GSTTacotron(cfg.model, NUM_SYMBOLS)
    packed = model.decoder.cell.pack(differentiable=True)
    assert work.decode_weights(spec["config"]) == sum(v.numel() for v in packed.values())


def test_wavernn_counts():
    cfg, spec = _cfg("gst_wavernn.synth")
    cd = spec["config"]
    n = work.wavernn_weights(cd)
    frames = cfg.model.decoder.max_decode_steps * cfg.model.decoder.reduction_factor
    for hoisted in (False, True):
        assert work.wavernn_sample_work(cd, 32, frames, 512, n, hoisted) == tuple(
            kb.wavernn_sample_work(cfg, 32, frames, 512, n, hoisted))


def test_gru_and_refenc_counts():
    assert work.gru_scan_work(32, 9, 256, 128) == tuple(kb.gru_scan_work(32, 9, 256, 128))
    assert work.gru_scan_work(32, 192, 128, 128, 2) == tuple(
        kb.gru_scan_work(32, 192, 128, 128, 2))
    ch = [32, 32, 64, 64, 128, 128]
    for bf16 in (False, True):
        assert work.refenc_stack_work(32, 576, 80, ch, bf16) == tuple(
            kb.refenc_stack_work(32, 576, 80, ch, bf16))


def test_synth_call_flops_by_stage():
    _, spec = _cfg("gst_lj.synth")
    cd = spec["config"]
    f = work.synth_call_flops(cd, 32, 192, [300] * 32, 576)
    assert set(f) == {"reference_mels", "style", "encoder", "decode", "postnet", "vocoder"}
    assert all(v > 0 for v in f.values())
    # Griffin-Lim: 61 real transforms of 2048 points a frame, 32 x 1000 frames
    assert f["vocoder"] == pytest.approx(32 * 1000 * 61 * 2.5 * 2048 * 11)
    assert f["decode"] > 500 * kb.decode_step_flops(_cfg("gst_lj.synth")[0], 32, 192, True)
