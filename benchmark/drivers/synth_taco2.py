"""Batch synthesis of Tacotron 2 with GST (``gst_taco2``): the synthesis
driver (``drivers/synth.py``) as it is, one client in a closed loop, with
the Tacotron 2 judge (``reference/judge_taco2.py``) in the reference judge's
place, and the model FLOPs and K4's least time of the LSTM decoder
(``work_taco2.py``) in place of the GRU decoder's counts.
"""

from __future__ import annotations

import importlib

from .. import common, work, work_taco2
from ..reference import judge_taco2
from . import synth


def run(ctx: common.Context, cfg=None, spec=None) -> common.Result:
    judge = synth.judge
    synth.judge = judge_taco2
    try:
        res = synth.run(ctx, cfg, spec)
    finally:
        synth.judge = judge
    if spec is None:
        _, spec = common.load_config(ctx.workload["config"])
    cd, run_opts, mix = spec["config"], spec["run"], ctx.workload["traffic"]
    traffic = importlib.import_module(f"benchmark.traffic.{mix['generator']}")
    b, sr = mix["batch"], cd["audio"]["sample_rate"]
    # every batch of the mix has these lengths, in some order
    texts = ["a" * int(n) for n in traffic.text_lengths(mix["text_chars"], b)]
    wavs = [range(int(round(s * sr))) for s in traffic.wav_seconds(mix["ref_seconds"], b)]
    t_text, ref_frames, t_ref = synth.shapes(cd, run_opts, texts, wavs)
    flops = work_taco2.synth_call_flops(cd, b, t_text, ref_frames, t_ref)
    u = res.layer["untraced"]
    u["flops"] = u["calls"] * sum(flops.values())
    steps = cd["model"]["decoder"]["max_decode_steps"]
    res.layer["bounds"]["decode_scan"] = work.bound_seconds(work_taco2.decode_scan_work(
        cd, b, t_text, steps, work_taco2.decode_weights(cd)))
    return res
