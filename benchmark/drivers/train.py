"""Training steps through ``train.train_step``, back to back, each on a
fresh host feature batch moved to the card, each ending with its loss
fetched.

Set-up makes the weights on the device from the seed, builds the one
training state (model, Adam's state) and the cell's batches (the mix's
generator under ``traffic/``), and drives that state through its first
three steps on three different batches: they are the warm-up, and what
the reference follows from the seed. The window runs the next steps for
``--seconds`` on the same state. A ``--trace 1`` run then profiles
``trace_steps`` more. Then the memory peak is read, the state is copied
(parameters, BatchNorm buffers, Adam's moments and count), and the
program takes one more step through the window's own call and feed: the
step the reference follows from the program's own state, since it cannot
follow the window's steps from the seed inside the window's time. The
program is freed, and the reference (``reference/train.py``) runs the
first three steps from the seed's weights and batches, and that last step
from the copy.

The numbers compared, for the first three steps and (``window_*``) for
the last one: the loss (relative, the worst step); the norm of each
parameter's gradient as Adam took it (from its first moment, which moves
by (1 - beta1) times the clipped gradient), by the worst parameter; and
the norm of each parameter's change, by the median parameter
(``change``) and by the worst (``change_worst``). A parameter's gap is the
gap between the program's norm and the reference's, over the larger of
the reference's norm and the median parameter's. Parameters whose
reference gradient is under a thousandth of the median's are left out
(their moves are round-off under Adam).
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
from ..reference import train as ref_train

WARM_STEPS = 3


def _norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in t.items()}


def compare(prog: Dict, ref: Dict) -> Tuple[Dict[str, float], Dict[str, object]]:
    """The training numbers of ``prog`` against ``ref`` (each a dict of
    ``losses``, the steps' totals, and ``grad`` and ``change``, norms by
    parameter), the parameter that sets each by-parameter number and the
    parameters left out."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    g_med = float(np.median(list(ref["grad"].values())))
    live = [k for k, g in ref["grad"].items() if g >= 1e-3 * g_med]
    nums, where = {"loss": loss}, {"left_out": sorted(set(ref["grad"]) - set(live))}
    gaps = {}
    for key in ("grad", "change"):
        med = float(np.median([ref[key][k] for k in live]))
        gaps[key] = {k: abs(prog[key][k] - ref[key][k]) / max(ref[key][k], med) for k in live}
        where[key] = max(gaps[key], key=gaps[key].get)
    nums["grad"] = gaps["grad"][where["grad"]]
    nums["change"] = float(np.median(list(gaps["change"].values())))
    nums["change_worst"] = gaps["change"][where["change"]]
    return nums, where


def reference_run(w, params: List[str], cd: dict, batches, seed: int, tf32: bool,
                  start=None) -> Dict:
    """The reference's ``batches`` from the weights ``w`` (and Adam's
    ``start``), as ``compare`` reads them."""
    w = dict(w)
    before = {k: w[k].clone() for k in params}
    with judge.precision(tf32):
        out = ref_train.steps(w, params, cd, batches, seed, start)
    return {"losses": [s["loss"] for s in out["losses"]], "grad": _norms(out["first_grads"]),
            "change": _norms({k: out["params"][k] - before[k] for k in params})}


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
    setup_s = time.time() - ctx.started

    attempted, failed, frames = 0, 0, 0.0
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
        else:
            failed += 1
        i += 1
    window = t_end - t0
    b, (max_text, max_frames) = mix["batch"], mix["bucket"]
    layer = {"untraced": {"calls": attempted - failed, "wall_s": window,
                          "flops": (attempted - failed)
                          * work.train_step_flops(cd, b, max_text, max_frames)},
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

    to_dev = lambda b: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
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
            # the fault of a step over half its batch, the mean taken over the rest
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
