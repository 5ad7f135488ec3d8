"""Data-parallel batch synthesis through ``DistributedSynthesizer``, one
rank a card over NCCL, one client in a closed loop: each call of the global
batch starts when the one before has returned.

The process the benchmark starts is rank 0; it starts the other ranks
(``WORKER``, this module as a program) and waits for each to end. Every rank
makes the same weights on its card from the seed and the same global
batches (the mix's generator under ``traffic/``), and calls
``DistributedSynthesizer.synthesize``, the port's data-parallel entry: each
rank runs its rows (the fixed-length mode, the global batch's dropout
rows), the outputs are all-gathered over the data axis, and each rank
returns the whole batch on the host. Before each call rank 0 broadcasts
whether the window is still open, so every rank runs the same calls. Rank 0
times the calls and, in a ``--trace 1`` run, profiles its own card (its
``busy_s`` is rank 0's). After the window (the ranks gone) rank 0 judges a
seeded sample of the calls' gathered outputs against the plain reference
over the whole global batch.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import common, trace, work
from .. import weights as bench_weights
from .synth import Reservoir, finite, judge_kept, shapes

WORKER = [sys.executable, "-m", "benchmark.drivers.dp_synth"]


def _flag(value: bool, dev: torch.device) -> bool:
    """Rank 0's ``value`` on every rank."""
    t = torch.tensor([1 if value else 0], device=dev)
    dist.broadcast(t, 0)
    return bool(t.item())


def _rank(rank: int, ranks: int, port: int, ctx: common.Context, cfg, spec
          ) -> Optional[common.Result]:
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.models.tacotron import GSTTacotron
    from gst_tacotron_tpu_torch.parallel.distributed_synthesis import DistributedSynthesizer
    from gst_tacotron_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from gst_tacotron_tpu_torch.text import NUM_SYMBOLS

    wl, cd, run_opts = ctx.workload, spec["config"], spec["run"]
    mix = wl["traffic"]
    cpu = ctx.device == "cpu"
    dev = torch.device("cpu") if cpu else torch.device("cuda", rank)
    initialize_distributed(f"localhost:{port}", ranks, rank, backend="gloo" if cpu else None)
    try:
        if not cpu:
            from gst_tacotron_tpu_torch.ops.build import build_all

            build_all(ops.all_kernels())
        mesh = make_mesh(1)
        model = GSTTacotron(cfg.model, cfg.model.num_symbols or NUM_SYMBOLS,
                            dtype=getattr(torch, cfg.model.compute_dtype)).to(dev)
        w = bench_weights.make({k: tuple(v.shape) for k, v in model.state_dict().items()},
                               ctx.seed, dev)
        model.load_state_dict(w)
        synth = DistributedSynthesizer(cfg, model.eval(), mesh, device=dev)
        traffic = importlib.import_module(f"benchmark.traffic.{mix['generator']}")
        batches = traffic.batches(mix, ctx.seed, cfg.audio.sample_rate)

        def call(i: int):
            texts, wavs = batches[i % len(batches)]
            return synth.synthesize(texts, wavs, seed=traffic.call_seed(ctx.seed, i))

        call(-1)        # every batch of the mix has the one padded shape
        setup_s = time.time() - ctx.started
        keep, failed = Reservoir(wl["check"]["calls"], ctx.seed), 0
        walls, audio, i = [], 0.0, 0
        common.quiet_gc()
        t0 = time.perf_counter()
        t_end = t0
        while _flag(time.perf_counter() - t0 < ctx.seconds, dev):
            c0 = time.perf_counter()
            out = call(i)
            t_end = time.perf_counter()
            if rank == 0:
                walls.append(t_end - c0)
                audio += float(np.sum(out["wav_lengths"])) / cfg.audio.sample_rate
                if finite(out):
                    keep.offer(i, out)
                else:
                    failed += 1
            i += 1
        window = t_end - t0
        summary, n = None, wl["trace_calls"]
        if ctx.trace:
            if rank == 0:
                def traced():
                    nonlocal i
                    call(i)
                    i += 1

                summary = trace.profile(traced, n, str(ctx.out_path),
                                        ops.reset_launch_counts, ops.launch_counts)
            else:
                for _ in range(n):
                    call(i)
                    i += 1
        peak = torch.tensor([0 if cpu else torch.cuda.max_memory_allocated(dev)],
                            dtype=torch.int64, device=dev)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        del synth, model
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return None
    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()

    texts0, wavs0 = batches[0]
    b = mix["batch"]
    t_text, ref_frames, t_ref = shapes(cd, run_opts, texts0, wavs0)
    steps = cd["model"]["decoder"]["max_decode_steps"]
    flops = sum(work.synth_call_flops(cd, b, t_text, ref_frames, t_ref).values())
    # the whole batch's decode bound over the ranks: one rank's share a card
    bounds = {"decode_scan": work.bound_seconds(work.decode_scan_work(
        cd, b // ranks, t_text, steps, work.decode_weights(cd)))}
    layer = {"untraced": {"calls": len(walls), "wall_s": window, "flops": len(walls) * flops},
             "bounds": bounds, "chips": ranks}
    device: Dict = {"platform": "gpu" if not cpu else "cpu",
                    "kind": "cpu" if cpu else torch.cuda.get_device_name(dev), "count": ranks,
                    "memory_peak_bytes": int(peak.item())}
    breakdown = None
    if summary is not None:
        layer.update(trace=summary, traced_calls=n)
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}

    worst, layer["control"] = judge_kept(keep.kept, batches, traffic.call_seed, ctx, w, cd,
                                         run_opts, wl["limits"], dev)
    checks = {k: {"value": worst.get(k, float("inf")), "limit": lim}
              for k, lim in wl["limits"].items()}
    correct = failed == 0 and bool(worst) and all(c["value"] <= c["limit"]
                                                  for c in checks.values())
    metrics = {"setup_s": setup_s, "audio_s_per_s": audio / window if window > 0 else 0.0,
               "batch_ms_p90": 1e3 * common.p90(walls) if walls else float("inf")}
    return common.Result(correct=correct, attempted=len(walls), failed=failed,
                         metrics=metrics, device=device, checks=checks, layer=layer,
                         breakdown=breakdown)


def _args(ctx: common.Context, rank: int, ranks: int, port: int) -> List[str]:
    return ["--rank", str(rank), "--ranks", str(ranks), "--port", str(port), "--workload",
            ctx.cell, "--seed", str(ctx.seed), "--seconds", str(ctx.seconds), "--trace",
            str(int(ctx.trace)), "--device", ctx.device, "--started", repr(ctx.started)]


def run(ctx: common.Context, cfg=None, spec=None) -> common.Result:
    from gst_tacotron_tpu_torch.parallel.mesh import free_port

    if cfg is None:
        cfg, spec = common.load_config(ctx.workload["config"])
    ranks, port = ctx.chips, free_port()
    procs = [subprocess.Popen(WORKER + _args(ctx, r, ranks, port), cwd=common.ROOT,
                              stdout=subprocess.DEVNULL) for r in range(1, ranks)]
    done = threading.Event()

    def watch():
        # a rank that dies leaves the others waiting in a collective: end all
        while not done.wait(1.0):
            if any(p.poll() not in (None, 0) for p in procs):
                common.log(f"a rank exited with {[p.poll() for p in procs]}; ending the run")
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    try:
        res = _rank(0, ranks, port, ctx, cfg, spec)
    finally:
        done.set()
        for p in procs:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    bad = [p.returncode for p in procs if p.returncode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return res


def worker(argv=None, cfg=None, spec=None) -> int:
    """A rank other than 0: the same calls, no result; exits 3 if JAX or the
    JAX package is loaded once its window has closed."""
    p = argparse.ArgumentParser()
    for name in ("--rank", "--ranks", "--port", "--seed"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--started", type=float, required=True)
    p.add_argument("--trace", type=int, required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--device", required=True)
    a = p.parse_args(argv)
    _, wl = common.load_cell(a.workload)
    torch.set_num_threads(1)
    if cfg is None:
        cfg, spec = common.load_config(wl["config"])
    ctx = common.Context(cell=a.workload, workload=wl, seed=a.seed, seconds=a.seconds,
                         trace=bool(a.trace), started=a.started, device=a.device)
    _rank(a.rank, a.ranks, a.port, ctx, cfg, spec)
    bad = common.forbidden_modules()
    if bad:
        common.log(f"rank {a.rank}: JAX or the JAX package is loaded: {', '.join(bad)}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(worker())
