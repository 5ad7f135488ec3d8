"""Batch synthesis through ``Synthesizer.__call__``, one client in a closed
loop: each call starts when the one before has returned its results to
the host.

Set-up builds the kernels, makes the weights on the device from the seed,
makes the cell's batches (the mix's generator under ``traffic/``) and warms their one padded
shape. The window runs calls for ``--seconds``, each on the next batch of
the cycle with a seed of its own (the prenet dropout stays on). A
``--trace 1`` run then profiles ``trace_calls`` more calls. After the
window the memory peak is read, the program is freed, and a seeded sample
of the window's calls (``check.calls`` of them, kept by reservoir
sampling) is judged against the plain reference (``reference/judge.py``);
with ``ctx.control`` the control is judged on the same calls too
(``benchmark/control.py``; the benchmark's own runs never do).
"""

from __future__ import annotations

import gc
import importlib
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import common, trace, work
from .. import weights as bench_weights
from ..reference import judge


def finite(out: Dict[str, np.ndarray]) -> bool:
    return bool(np.isfinite(np.sum(out["wav"])) and np.isfinite(np.sum(out["mel"])))


def build(cfg, seed: int, dev: torch.device):
    """(Synthesizer, its weights, the vocoder's weights or None)."""
    from gst_tacotron_tpu_torch.models.tacotron import GSTTacotron
    from gst_tacotron_tpu_torch.models.wavernn import WaveRNN
    from gst_tacotron_tpu_torch.synthesize import Synthesizer
    from gst_tacotron_tpu_torch.text import NUM_SYMBOLS
    from gst_tacotron_tpu_torch.vocoder import WaveRNNVocoder

    model = GSTTacotron(cfg.model, cfg.model.num_symbols or NUM_SYMBOLS,
                        dtype=getattr(torch, cfg.model.compute_dtype)).to(dev)
    w = bench_weights.make({k: tuple(v.shape) for k, v in model.state_dict().items()}, seed, dev)
    model.load_state_dict(w)
    vocoder, vw = None, None
    if cfg.model.vocoder.kind == "wavernn":
        voc = WaveRNN(cfg.model.vocoder, cfg.model.num_mels).to(dev)
        vw = bench_weights.make({k: tuple(v.shape) for k, v in voc.state_dict().items()},
                                seed + 1, dev)
        voc.load_state_dict(vw)
        vocoder = WaveRNNVocoder(cfg, voc, device=dev)
    return Synthesizer(cfg, model.eval(), device=dev, vocoder=vocoder), w, vw


def shapes(cd: dict, run: dict, texts, wavs) -> Tuple[int, List[int], int]:
    """(padded text length, each style wav's frames, padded style frames)."""
    a = cd["audio"]
    t_text = -(-(max(len(t) for t in texts) + 1) // run["text_pad_multiple"]) \
        * run["text_pad_multiple"]
    frames = [1 + len(x) // a["hop_length"] for x in wavs]
    return t_text, frames, -(-max(frames) // 64) * 64


def stated_precision(run: dict, launches: Dict[str, int]) -> List[str]:
    """Where the card's launches depart from the precisions the
    configuration states for the style wavs' mels and the style stack."""
    bad = []
    for key, counter, total in (("ref_mel_bf16", "stft_features:bf16", "stft_features"),
                                ("ref_stack_bf16", "refenc_stack:bf16", "refenc_stack")):
        if launches.get(total, 0) and bool(launches.get(counter, 0)) != bool(run[key]):
            bad.append(f"{key} is {run[key]} but {counter} launched {launches.get(counter, 0)}"
                       f" of {launches.get(total, 0)}")
    return bad


class Reservoir:
    """A seeded uniform sample of ``k`` of the calls offered (reservoir
    sampling): which calls are judged, drawn from the run's seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.kept = k, 0, []
        self.rng = np.random.default_rng([seed % (1 << 62), 17])

    def offer(self, i: int, out) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((i, out))
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.kept[j] = (i, out)


def judge_kept(kept, batches, call_seed, ctx: common.Context, w, cd: dict, run_opts: dict,
               limits: dict, dev, **kw) -> Tuple[Dict[str, float], Dict[str, float]]:
    """The worst of each number over the kept calls, and with ``ctx.control``
    the control's on the same calls; outputs the reference cannot read
    score infinity."""
    worst: Dict[str, float] = {}
    control: Dict[str, float] = {}
    for idx, out in kept:
        texts, wavs = batches[idx % len(batches)]
        args = (w, cd, run_opts, texts, wavs, call_seed(ctx.seed, idx), out)
        for into, fn in ((worst, judge.judge),) + (((control, judge.control),)
                                                   if ctx.control else ()):
            try:
                nums = fn(*args, device=dev, **kw)
            except Exception as e:      # outputs the reference cannot read
                common.log(f"judging call {idx}: {type(e).__name__}: {e}")
                nums = {k: float("inf") for k in limits}
            for k, v in nums.items():
                into[k] = max(into.get(k, 0.0), v)
    return worst, control


def run(ctx: common.Context, cfg=None, spec=None) -> common.Result:
    from gst_tacotron_tpu_torch import ops

    wl = ctx.workload
    if cfg is None:
        cfg, spec = common.load_config(wl["config"])
    cd, run_opts, mix = spec["config"], spec["run"], wl["traffic"]
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        from gst_tacotron_tpu_torch.ops.build import build_all

        build_all(ops.all_kernels())
    synth, w, vw = build(cfg, ctx.seed, dev)
    traffic = importlib.import_module(f"benchmark.traffic.{mix['generator']}")
    batches = traffic.batches(mix, ctx.seed, cfg.audio.sample_rate)
    sr = cfg.audio.sample_rate

    def call(i: int):
        texts, wavs = batches[i % len(batches)]
        return synth(texts, reference_wavs=wavs, seed=traffic.call_seed(ctx.seed, i))

    ops.reset_launch_counts()
    call(-1)        # every batch of the mix has the one padded shape
    launches = ops.launch_counts()
    setup_s = time.time() - ctx.started

    keep = Reservoir(wl["check"]["calls"], ctx.seed)
    walls, audio, attempted, failed = [], 0.0, 0, 0
    common.quiet_gc()
    t0 = time.perf_counter()
    t_end, i = t0, 0
    while time.perf_counter() - t0 < ctx.seconds:
        c0 = time.perf_counter()
        try:
            out = call(i)
            ok = finite(out)
        except Exception as e:          # a call that raises has failed
            common.log(f"call {i} raised {type(e).__name__}: {e}")
            out, ok = None, False
        t_end = time.perf_counter()
        attempted += 1
        if ok:
            walls.append(t_end - c0)
            audio += float(np.sum(out["wav_lengths"])) / sr
            keep.offer(i, out)
        else:
            failed += 1
        i += 1
    window = t_end - t0
    if walls:
        common.log(f"{len(walls)} calls; the first {1e3 * walls[0]:.1f} ms, the median "
                   f"{1e3 * float(np.median(walls)):.1f} ms")
    texts0, wavs0 = batches[0]
    t_text, ref_frames, t_ref = shapes(cd, run_opts, texts0, wavs0)
    b = mix["batch"]
    steps = cd["model"]["decoder"]["max_decode_steps"]
    frames = steps * cd["model"]["decoder"]["reduction_factor"]
    flops = work.synth_call_flops(cd, b, t_text, ref_frames, t_ref)
    bounds = {"decode_scan": work.bound_seconds(work.decode_scan_work(
        cd, b, t_text, steps, work.decode_weights(cd)))}
    if vw is not None:
        v = cd["model"]["vocoder"]
        bounds["wavernn_sample"] = work.bound_seconds(work.wavernn_sample_work(
            cd, b, frames, v["wavernn_fc_dim"], work.wavernn_weights(cd), hoisted=True))
    layer = {"untraced": {"calls": len(walls), "wall_s": window,
                          "flops": len(walls) * sum(flops.values())},
             "bounds": bounds, "chips": 1}
    device: Dict = {"platform": "gpu" if cuda else "cpu",
                    "kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "count": 1}
    breakdown = None
    if ctx.trace:
        def traced():
            nonlocal i, attempted, failed
            out = call(i)
            attempted += 1
            failed += 0 if finite(out) else 1
            i += 1

        n = wl["trace_calls"]
        summary = trace.profile(traced, n, str(ctx.out_path), ops.reset_launch_counts,
                                ops.launch_counts)
        layer.update(trace=summary, traced_calls=n)
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    if cuda:
        device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    else:
        device["memory_peak_bytes"] = 0
    del synth
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    unsound = stated_precision(run_opts, launches) if cuda else []
    for u in unsound:
        common.log(f"not as configured: {u}")
    rows = sorted(keep.rng.choice(b, min(b, wl["check"].get("gap_rows", b)), replace=False)
                  .tolist())
    worst, layer["control"] = judge_kept(keep.kept, batches, traffic.call_seed, ctx, w, cd,
                                         run_opts, wl["limits"], dev, vocoder_w=vw,
                                         gap_rows=rows)
    keep.kept.clear()
    limits = wl["limits"]
    checks = {k: {"value": worst.get(k, float("inf")), "limit": lim} for k, lim in limits.items()}
    correct = (not unsound and failed == 0 and bool(worst)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    metrics = {"setup_s": setup_s,
               "audio_s_per_s": audio / window if window > 0 else 0.0,
               "batch_ms_p90": 1e3 * common.p90(walls) if walls else float("inf")}
    return common.Result(correct=correct, attempted=attempted, failed=failed, metrics=metrics,
                         device=device, checks=checks, layer=layer, breakdown=breakdown)
