"""Training steps over several buckets through ``train.train_step``: the
training driver's steps, judging and numbers (``drivers/train.py``, imported
as it is), with one padded shape a bucket.

Set-up takes the training driver's three warm-up steps on the cycle's first
three batches (the steps the reference follows from the seed), then one
more step on each of them, so that every bucket's shape has run eager and
been captured as its CUDA graph (``train.StepGraphs``) before the window;
the window then runs the cycle from its fourth batch on, every step a
replay. The model FLOPs are counted a step at its own bucket's shape.
"""

from __future__ import annotations

import gc
import importlib
import time
from typing import Dict

import numpy as np
import torch

from .. import common, trace, work
from .. import weights as bench_weights
from .train import WARM_STEPS, _norms, compare, reference_run


def run(ctx: common.Context, cfg=None, spec=None) -> common.Result:
    from gst_tacotron_tpu_torch.models.tacotron import GSTTacotron
    from gst_tacotron_tpu_torch.text import NUM_SYMBOLS
    from gst_tacotron_tpu_torch.train import TrainState, make_optimizer, train_step

    wl = ctx.workload
    if cfg is None:
        cfg, spec = common.load_config(wl["config"])
    cd, mix = spec["config"], wl["traffic"]
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    model = GSTTacotron(cfg.model, cfg.model.num_symbols or NUM_SYMBOLS,
                        dtype=getattr(torch, cfg.model.compute_dtype)).to(dev)
    w = bench_weights.make({k: tuple(v.shape) for k, v in model.state_dict().items()},
                           ctx.seed, dev)
    model.load_state_dict(w)
    model.eval()
    tx = make_optimizer(cfg.optimizer)
    params = dict(model.named_parameters())
    state = TrainState(0, model, tx.init(params), ctx.seed)
    traffic = importlib.import_module(f"benchmark.traffic.{mix['generator']}")
    host = traffic.batches(mix, ctx.seed, cfg.model.num_mels, cfg.model.num_freq)
    frames_per_step = [float(np.sum(b["mel_lengths"])) for b in host]
    b = mix["batch"]
    flops_per_step = [work.train_step_flops(cd, b, *bucket) for bucket in mix["cycle"]]

    def step(i: int) -> float:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host[i % len(host)].items()}
        return float(train_step(tx, cfg, state, batch)["loss"])

    p0 = {k: p.detach().clone() for k, p in params.items()}
    prog = {"losses": []}
    for i in range(WARM_STEPS):
        prog["losses"].append(step(i))
        if i == 0:
            b1 = cfg.optimizer.beta1
            prog["grad"] = _norms({k: state.opt.mu[k] / (1 - b1) for k in params})
    prog["change"] = _norms({k: p.detach() - p0[k] for k, p in params.items()})
    del p0
    # every bucket's second step: its graph captured before the window
    for i in range(WARM_STEPS):
        step(i)
    setup_s = time.time() - ctx.started

    attempted, failed, frames, flops = 0, 0, 0.0, 0.0
    common.quiet_gc()
    t0 = time.perf_counter()
    t_end, i = t0, WARM_STEPS
    while time.perf_counter() - t0 < ctx.seconds:
        try:
            ok = bool(np.isfinite(step(i)))
        except Exception as e:          # a step that raises has failed
            common.log(f"step {i} raised {type(e).__name__}: {e}")
            ok = False
        t_end = time.perf_counter()
        attempted += 1
        if ok:
            frames += frames_per_step[i % len(host)]
            flops += flops_per_step[i % len(host)]
        else:
            failed += 1
        i += 1
    window = t_end - t0
    layer: Dict = {"untraced": {"calls": attempted - failed, "wall_s": window, "flops": flops},
                   "chips": 1}
    device: Dict = {"platform": "gpu" if cuda else "cpu",
                    "kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "count": 1}
    breakdown = None
    if ctx.trace:
        def traced():
            nonlocal i, attempted
            step(i)
            attempted += 1
            i += 1

        n = wl["trace_steps"]
        summary = trace.profile(traced, n, str(ctx.out_path))
        layer.update(trace=summary, traced_calls=n)
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    # the state the window left, and one more step from it through the
    # window's own call and feed
    snap = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = state.opt
    start = (opt.count, {k: m.clone() for k, m in opt.mu.items()},
             {k: m.clone() for k, m in opt.nu.items()})
    last_batch, b1 = host[i % len(host)], cfg.optimizer.beta1
    last = {"losses": [step(i)],
            "grad": _norms({k: (opt.mu[k] - b1 * start[1][k]) / (1 - b1) for k in params}),
            "change": _norms({k: p.detach() - snap[k] for k, p in params.items()})}
    names = list(params)
    del state, model, params, opt
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    to_dev = lambda bt: {k: torch.from_numpy(v).to(dev) for k, v in bt.items()}
    runs = {"": (w, [to_dev(host[j]) for j in range(WARM_STEPS)], None, prog),
            "window_": (snap, [to_dev(last_batch)], start, last)}
    nums: Dict[str, float] = {}
    layer["worst"], layer["control"], layer["faults"] = {}, {}, {"half": {}}
    for prefix, (w0, batches, st, got) in runs.items():
        ref = reference_run(w0, names, cd, batches, ctx.seed, False, st)
        n, layer["worst"][prefix or "first_"] = compare(got, ref)
        nums.update({prefix + k: v for k, v in n.items()})
        if ctx.control:
            ctl, _ = compare(reference_run(w0, names, cd, batches, ctx.seed, True, st), ref)
            half = [{k: v[: v.shape[0] // 2] for k, v in bt.items()} for bt in batches]
            flt, _ = compare(reference_run(w0, names, cd, half, ctx.seed, False, st), ref)
            layer["control"].update({prefix + k: v for k, v in ctl.items()})
            layer["faults"]["half"].update({prefix + k: v for k, v in flt.items()})
    checks = {k: {"value": nums[k], "limit": lim} for k, lim in wl["limits"].items()}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {"setup_s": setup_s,
               "train_frames_per_s": frames / window if window > 0 else 0.0}
    return common.Result(correct=correct, attempted=attempted, failed=failed, metrics=metrics,
                         device=device, checks=checks, layer=layer, breakdown=breakdown)
