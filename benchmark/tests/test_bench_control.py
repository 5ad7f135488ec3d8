"""The control on the card: the reference computed a precision down (TF32
for float32 products, float8 for the bf16 ones), put in the program's
place, fails a synthesis cell's limits, while the float32 reference's own
outputs pass them. At small widths, so that a test run holds it; the
cells' readings at their own sizes come from ``python -m
benchmark.control`` (PERF.md)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import small
from benchmark import common, weights
from benchmark.reference import dsp, judge, tacotron
from benchmark.traffic import synth as traffic


@pytest.mark.cuda
def test_the_control_fails_what_the_reference_passes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TF32 exists only there)")
    from gst_tacotron_tpu_torch.models.tacotron import GSTTacotron
    from gst_tacotron_tpu_torch.text import NUM_SYMBOLS

    cfg, spec = small.config()
    cd, run = spec["config"], spec["run"]
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in GSTTacotron(cfg.model, NUM_SYMBOLS)
                  .state_dict().items()}
    w = weights.make(shapes, 11, "cuda")
    texts, wavs = traffic.batches(small.MIX, 12, cfg.audio.sample_rate)[0]
    limits = common.read_json(common.HERE / "workloads" / "gst_lj.synth.json")["limits"]
    with judge.precision(False):
        ref_mel, ref_len = dsp.reference_mels(wavs, cd["audio"], "cuda", bf16=False)
        out = tacotron.synthesize(w, cd, texts, ref_mel, ref_len, 5)
        out["wav"] = dsp.GriffinLim(cd["audio"], "cuda")(out["linear"])
    host = {k: v if isinstance(v, np.ndarray) else v.cpu().numpy() for k, v in out.items()}
    own = judge.judge(w, cd, run, texts, wavs, 5, host, device="cuda")
    assert all(own[k] <= lim for k, lim in limits.items()), own
    ctl = judge.control(w, cd, run, texts, wavs, 5, host, device="cuda")
    assert any(ctl[k] > lim for k, lim in limits.items()), ctl
