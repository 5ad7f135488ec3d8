"""Worker functions that tests start in spawned processes. A spawned child
imports the module of its function; this one imports torch and the port
only, so a child starts in seconds (a test module would import JAX).

``run_ranks(name, world, *args)`` starts ``world`` ranks of a gloo group on
the CPU, each calling ``name(rank, *args)`` of this module, and returns
their results by rank; a rank that raises fails the call with its
traceback. With ``join=False`` the ranks join no group (the function
starts its own: the CLIs)."""

import multiprocessing
import traceback

import numpy as np
import torch


def consensus_worker(rank, port, flags, out):
    """Join a 2-process gloo group and put (rank, the stop consensus of each
    of ``flags[rank]``) on ``out``."""
    import torch.distributed as dist

    from gst_tacotron_tpu_torch.decode import data_parallel_stop_consensus

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    try:
        reduce = data_parallel_stop_consensus()
        out.put((rank, [reduce(torch.tensor(f)).tolist() for f in flags[rank]]))
    finally:
        dist.destroy_process_group()


def _entry(name, rank, world, port, join, args, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if join:
            dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                    world_size=world)
        try:
            out.put((rank, True, globals()[name](rank, *args)))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def run_ranks(name, world, *args, join=True, timeout=150):
    """Results of ``name(rank, *args)`` on ranks 0..world-1, by rank."""
    from gst_tacotron_tpu_torch.parallel.mesh import free_port

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(name, r, world, port, join, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, ok, value = out.get(timeout=timeout)
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert all(not p.is_alive() for p in procs)
    return [results[r] for r in range(world)]


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _numpy(tree):
    return {k: v.detach().numpy() for k, v in tree.items()}


def train_steps(rank, cfg, meshes, batches, flat=None):
    """For each model size M of ``meshes``: ``train_step`` on this rank's
    rows of each global batch under a (world / M, M) mesh from the seeded
    init (or the flat JAX variables ``flat``) -> [{"metrics" per step,
    "grads" of step 1 (whole), "model" (the whole state after the steps),
    "sharded"}] (rank 0's; None elsewhere)."""
    from gst_tacotron_tpu_torch.parallel import make_mesh, place_state, shard_batch
    from gst_tacotron_tpu_torch.parallel.sharding import gather_tree, named_parameters
    from gst_tacotron_tpu_torch.train import (init_state, make_optimizer, state_dict,
                                              train_step)
    from gst_tacotron_tpu_torch.weights import load_flat

    runs = []
    for model_parallelism in meshes:
        mesh = make_mesh(model_parallelism)
        _, state = init_state(cfg, "cpu")
        if flat is not None:
            load_flat(state.model, flat)
        place_state(state, mesh)
        tx = make_optimizer(cfg.optimizer)
        metrics, grads = [], None
        for b in batches:
            m = train_step(tx, cfg, state, _tensors(shard_batch(b, mesh)))
            metrics.append({k: float(v) for k, v in m.items()})
            if grads is None:
                grads = gather_tree({k: p.grad for k, p in named_parameters(state.model).items()},
                                    state.sharded, mesh)
        saved = state_dict(state)
        runs.append({"metrics": metrics, "grads": _numpy(grads), "model": _numpy(saved["model"]),
                     "sharded": sorted(state.sharded)} if rank == 0 else None)
    return runs


def synthesize(rank, calls):
    """``DistributedSynthesizer.synthesize`` of the seed-0 model for each
    (config, model size M, kwargs) of ``calls`` under a (world / M, M) mesh;
    under M > 1 the model's ruled kernels are stored sharded first (the
    synthesizer gathers them) -> each call's (sharded keys, host arrays, or
    the message of the ValueError it raised)."""
    from gst_tacotron_tpu_torch.parallel import DistributedSynthesizer, make_mesh, shard_params
    from gst_tacotron_tpu_torch.weights import build_model

    results = []
    for cfg, model_parallelism, kwargs in calls:
        mesh = make_mesh(model_parallelism)
        model = build_model(cfg, seed=0, device="cpu")
        sharded = shard_params(model, mesh)
        ds = DistributedSynthesizer(cfg, model, mesh, device="cpu")
        try:
            out = ds.synthesize(**kwargs)
        except ValueError as e:
            out = str(e)
        results.append((sorted(sharded), out))
    return results


def synthesize_inputs(rank, cfg, flat, inputs, calls):
    """``DistributedSynthesizer.__call__`` at dp = world of a model with the
    flat (JAX) variables ``flat`` on the global ``inputs``, once for each
    kwargs of ``calls`` -> host arrays."""
    from gst_tacotron_tpu_torch.parallel import DistributedSynthesizer, make_mesh
    from gst_tacotron_tpu_torch.weights import build_model

    ds = DistributedSynthesizer(cfg, build_model(cfg, flat=flat, device="cpu"), make_mesh(1),
                                device="cpu")
    return [{k: v.numpy() if torch.is_tensor(v) else v for k, v in ds(**inputs, **kw).items()}
            for kw in calls]


def calls(rank, calls):
    """Several workers of this module in one group: [name(rank, *args) for
    (name, args) in calls]."""
    return [globals()[name](rank, *args) for name, args in calls]


def vocoder_steps(rank, cfg, meshes, patterns, batches):
    """For each model size M of ``meshes``: ``VocoderTrainer.step`` on this
    rank's rows of each global batch under a (world / M, M) mesh (its loader
    over ``patterns`` stays unused) -> [{"metrics", "model" (whole, after
    the steps), "sharded"}] (rank 0's)."""
    import tempfile

    from gst_tacotron_tpu_torch.parallel import make_mesh, shard_batch
    from gst_tacotron_tpu_torch.train import state_dict
    from gst_tacotron_tpu_torch.vocoder_train import VocoderTrainer

    runs = []
    for model_parallelism in meshes:
        mesh = make_mesh(model_parallelism)
        with tempfile.TemporaryDirectory() as work:
            tr = VocoderTrainer(cfg, patterns, work, device="cpu", segment_frames=4,
                                batch_size=len(batches[0]["mel"]), mesh=mesh)
            metrics = [{k: float(v) for k, v in tr.step(shard_batch(b, mesh)).items()}
                       for b in batches]
            saved = state_dict(tr.state)
        runs.append({"metrics": metrics, "model": _numpy(saved["model"]),
                     "sharded": sorted(tr.state.sharded)} if rank == 0 else None)
    return runs


def wavernn_sample(rank, cfg, mel, seed):
    """The plain WaveRNN sampler on this rank's rows of ``mel`` at dp =
    world, under ``data_parallel`` -> the whole batch's classes."""
    from gst_tacotron_tpu_torch.models.modules import data_parallel
    from gst_tacotron_tpu_torch.parallel import make_mesh, shard_batch
    from gst_tacotron_tpu_torch.parallel.mesh import all_gather
    from gst_tacotron_tpu_torch.weights import build_wavernn

    mesh = make_mesh(1)
    model = build_wavernn(cfg, seed=1, device="cpu")
    local = torch.from_numpy(shard_batch({"mel": mel}, mesh)["mel"])
    with torch.no_grad(), data_parallel(model, mesh.data_shard()):
        classes = model.sample_classes(local, seed=seed)
    return all_gather(classes, mesh.data_group).numpy()


def step_gradients(rank, model_parallelism):
    """``sharding.step_gradients`` under a (world / M, M) mesh of rank-made
    gradients: a replicated "bias" of ``rank + 1`` (off by one ulp on the
    odd ranks) and a sharded "kernel" block of ``10 * (rank + 1)`` -> both,
    as numpy."""
    from gst_tacotron_tpu_torch.parallel import make_mesh
    from gst_tacotron_tpu_torch.parallel.sharding import step_gradients

    bias = torch.full((3,), float(rank + 1))
    if rank % 2:
        bias = torch.nextafter(bias, torch.tensor(np.inf))
    grads = {"bias": bias, "kernel": torch.full((2, 2), 10.0 * (rank + 1))}
    return _numpy(step_gradients(make_mesh(model_parallelism), grads,
                                 frozenset({"kernel"})))


def train_cli(rank, argv):
    """``train.main(argv + ["--process-id", rank])`` (run with
    ``join=False``: the CLI starts its own group)."""
    from gst_tacotron_tpu_torch.train import main

    main(argv + ["--process-id", str(rank)])
    return True


def trainer_losses(rank, cfg, patterns, work, steps):
    """``Trainer(..., mesh=make_mesh(1))`` trained ``steps`` steps from its
    loader (this rank's shard of each global batch) -> each step's loss."""
    from gst_tacotron_tpu_torch.parallel import make_mesh
    from gst_tacotron_tpu_torch.train import Trainer

    losses = []
    trainer = Trainer(cfg, patterns, work, device="cpu", mesh=make_mesh(1))
    trainer.train(steps, on_step=lambda tr, step, m, frames: losses.append(float(m["loss"])))
    return losses


def dsynth_spans(rank, cfg, kwargs, log_dir):
    """``DistributedSynthesizer.synthesize(**kwargs)`` at dp = world under
    ``profile_trace(log_dir)`` -> the trace's ``gst.*`` events as (name,
    start, end, args) and the program's counters after the call."""
    import json
    import os

    from gst_tacotron_tpu_torch.parallel import DistributedSynthesizer, make_mesh
    from gst_tacotron_tpu_torch.utils import profiling
    from gst_tacotron_tpu_torch.weights import build_model

    ds = DistributedSynthesizer(cfg, build_model(cfg, seed=0, device="cpu"), make_mesh(1),
                                device="cpu")
    profiling.reset_counters()
    with profiling.profile_trace(log_dir):
        ds.synthesize(**kwargs)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return ([(e["name"], e["ts"], e["ts"] + e["dur"], e["args"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("gst.")],
            profiling.counters())
