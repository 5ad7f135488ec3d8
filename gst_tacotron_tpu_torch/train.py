"""Trainer (counterpart of ``gst_tacotron_tpu/train.py``).

One train step is the teacher-forced forward (the GST reference is the
target mel), the losses of ``losses.py``, the backward, and the optax
chain of the JAX package written over tensors: global-norm clipping, Adam,
decayed weights, the learning-rate schedule, negation. The bucketed loader
feeds it feature batches, wav-transport batches (features computed on the
device, ``_materialize_features``) or row indices into a corpus held on the
device (``data.device_corpus``). Checkpoints are ``torch.save`` files
(``checkpoint.py``), metrics JSONL and TensorBoard (``metrics.py``). A JAX
trainer's workdir exported by ``tools/export_jax_workdir.py`` resumes here
too: its parameters, batch statistics, Adam state and step (not its PRNG
key).

The train step launches no kernel: every recurrence in it is a plain masked
scan, as in the JAX step (its GRUs take the Pallas kernel only when not
training, its decoder is a scan and its features the plain transform), and
the kernels have no backward. Kernels run where the trainer synthesizes:
the eval hook (``default_eval_hook``) and the held-out eval's GRUs and
reference encoder, under ``torch.no_grad()``.

Dropout is a pure function of (``train.seed``, step): the encoder prenet
draws from a generator seeded with ``dropout_seed``, the decoder prenet from
the decode kernel's Philox stream keyed by it plus one, so a resumed run
replays the same masks.

Under a mesh (``parallel.make_mesh``; ``Trainer(..., mesh=)``) a step is
the single-device step on the global batch, as GSPMD computes the JAX step:
each rank loads its rows (``parallel.process_data_shard``), its losses are
its numerators over the global denominators, BatchNorm takes the global
statistics and dropout draws the global batch's masks
(``models.modules.data_parallel``); the gradients are summed over the data
axis; the ruled kernels are stored sharded over the model axis
(``parallel.sharding``) and the global norm sums their blocks' squares over
it. Rank 0 writes the logs and the checkpoints (the whole state, shards
gathered: any mesh restores it).

    python -m gst_tacotron_tpu_torch.train --preset gst_lj --patterns P --workdir W
    # N processes (N cards, or the CPU with --device cpu), rank i:
    python -m gst_tacotron_tpu_torch.train ... --coordinator HOST:PORT \
        --num-processes N --process-id i [--model-parallelism M]
"""

from __future__ import annotations

import argparse
import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch

from .checkpoint import CheckpointManager
from .config import (Config, OptimizerConfig, apply_overrides, get_preset, load_config,
                     parse_cli_overrides, save_config)
from .data import BucketedLoader, PatternDataset
from .dsp.torch_dsp import TorchDSP
from .losses import compute_losses
from .metrics import MetricLogger
from .models.tacotron import GSTTacotron
from .parallel import mesh as pmesh
from .parallel import sharding
from .utils.profiling import StepWindowProfiler, next_call, span
from .weights import build_model

# the eval step's dropout stream (the JAX step's fold_in(rng, 2**31 - 1))
EVAL_STREAM = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# Optimizer: the JAX package's optax chain, over tensors
# ---------------------------------------------------------------------------


def make_schedule(cfg: OptimizerConfig) -> Callable[[Any], torch.Tensor]:
    """count -> float32 learning rate: noam, exponential (``lr *
    rate**(count / steps)``, not staircase) or constant. Update n takes
    ``sched(n)``, counting from 0."""
    lr = cfg.learning_rate
    if cfg.schedule == "noam":
        w = float(cfg.warmup_steps)

        def sched(count):
            step = torch.clamp(torch.as_tensor(count), min=1).to(torch.float32)
            # step^-0.5 correctly rounded (float32 rsqrt is off by an ulp at
            # a quarter of the counts)
            inv_sqrt = step.to(torch.float64).rsqrt().to(torch.float32)
            return lr * w ** 0.5 * torch.minimum(step * w ** -1.5, inv_sqrt)
        return sched
    if cfg.schedule == "exponential":
        if cfg.decay_steps <= 0 or cfg.decay_rate == 0:
            return lambda count: torch.tensor(lr, dtype=torch.float32)

        def sched(count):
            count = torch.as_tensor(count)
            p = count.to(torch.float32) / cfg.decay_steps
            decayed = lr * torch.pow(torch.tensor(cfg.decay_rate, dtype=torch.float32), p)
            return torch.where(count <= 0, torch.tensor(lr, dtype=torch.float32), decayed)
        return sched
    return lambda count: torch.tensor(lr, dtype=torch.float32)


@dataclass
class OptState:
    """Adam's moments by parameter name and the update count (the optax
    chain's Adam and schedule counts, which move together)."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((t * t).sum() for t in tensors))


class Optimizer:
    """optax's ``chain(clip_by_global_norm, scale_by_adam(b1, b2, eps),
    add_decayed_weights, scale_by_schedule, scale(-1))`` of optax 0.2.6:
    clip as ``(g / norm) * max_norm`` when norm >= max_norm (not
    ``clip_grad_norm_``, whose +1e-6 differs); Adam's eps outside the
    square root and bias correction at count + 1."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        return OptState(0, zeros(), zeros())

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: OptState, sharded: FrozenSet[str] = frozenset(),
               model_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
               ) -> torch.Tensor:
        """Apply one update to ``params`` in place and advance ``state``;
        returns the gradients' global norm before clipping. ``sharded`` keys
        hold one model rank's column block each: their squares are summed
        over the model axis by ``model_sum`` (Adam works element by element
        on the block)."""
        c = self.cfg
        if not sharded:
            norm = global_norm(grads.values())
        else:
            sq = lambda keys: sum((grads[k] * grads[k]).sum() for k in keys)
            norm = torch.sqrt(sq([k for k in grads if k not in sharded])
                              + model_sum(sq(sorted(sharded))))
        keep = norm < c.grad_clip_norm
        count = state.count + 1
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        bc1 = (1 - f32(c.beta1) ** count).to(norm.device)
        bc2 = (1 - f32(c.beta2) ** count).to(norm.device)
        lr = self.schedule(state.count).to(norm.device)
        for k, p in params.items():
            g = torch.where(keep, grads[k], (grads[k] / norm) * c.grad_clip_norm)
            mu = (1 - c.beta1) * g + c.beta1 * state.mu[k]
            nu = (1 - c.beta2) * (g * g) + c.beta2 * state.nu[k]
            state.mu[k], state.nu[k] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + c.eps)
            if c.weight_decay > 0:
                u = u + c.weight_decay * p
            p.add_(-(lr * u))
        state.count = count
        return norm


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return Optimizer(cfg)


# ---------------------------------------------------------------------------
# State, batches and steps
# ---------------------------------------------------------------------------


@dataclass
class TrainState:
    """The model (parameters and BatchNorm buffers), Adam's state, the steps
    taken and the root of the dropout streams; under a mesh
    (``parallel.place_state``) the mesh and the keys of the parameters
    stored sharded over its model axis."""
    step: int
    model: torch.nn.Module
    opt: OptState
    seed: int
    mesh: Optional[pmesh.Mesh] = None
    sharded: FrozenSet[str] = field(default_factory=frozenset)

    def data_shard(self):
        """The modules' ``DataShard`` of this rank (None without a mesh)."""
        return None if self.mesh is None else self.mesh.data_shard()


def dropout_seed(seed: int, step: int) -> int:
    """The dropout streams' key at ``step``: the run's seed in the high 32
    bits, the step in the low."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def init_state(cfg: Config, device=None) -> Tuple[GSTTacotron, TrainState]:
    """A seeded model on ``device`` (``cuda`` unless named) and its state."""
    model = build_model(cfg, seed=cfg.train.seed, device=device)
    params = dict(model.named_parameters())
    return model, TrainState(0, model, make_optimizer(cfg.optimizer).init(params),
                             cfg.train.seed)


def _materialize_features(cfg: Config, batch: Dict[str, Any]) -> Dict[str, Any]:
    """Wav-transport batches -> feature batches, on the tensors' device.

    Unpacks the loader's {"wav" float16, "ints" int32} wire batch and runs the
    plain feature path (``TorchDSP.features_precentered``, as the JAX step
    runs ``JaxDSP.features_precentered``). Frames past each utterance's true
    length are zeroed, so the result matches the zero-padded feature batches.
    A batch without "wav" is returned as it is."""
    if "wav" not in batch:
        return batch
    ints = batch["ints"]
    wav = batch["wav"].to(torch.float32)
    dsp = TorchDSP(cfg.audio, wav.device)
    tmax = ints.shape[1] - 4
    mel, lin = dsp.features_precentered(wav)
    true_frames = ints[:, tmax + 2]
    fmask = (torch.arange(mel.shape[1], device=mel.device)[None, :]
             < true_frames[:, None]).to(mel.dtype)[:, :, None]
    return {
        "tokens": ints[:, :tmax],
        "token_lengths": ints[:, tmax],
        "mel_lengths": ints[:, tmax + 1],
        "speaker_ids": ints[:, tmax + 3],
        "mel": mel * fmask,
        "linear": lin * fmask,
    }


def _model_kwargs(cfg: Config, batch: Dict[str, Any]) -> Dict[str, Any]:
    kwargs: Dict[str, Any] = {}
    if cfg.model.gst.enabled:
        kwargs["ref_mel"] = batch["mel"]
        kwargs["ref_mel_lengths"] = batch["mel_lengths"]
    if cfg.model.num_speakers > 1:
        kwargs["speaker_ids"] = batch["speaker_ids"]
    return kwargs


def _forward_losses(cfg: Config, model: torch.nn.Module, batch, *, train: bool, seed: int,
                    shard=None):
    with span("gst.train.forward"):
        outputs = model(batch["tokens"], batch["token_lengths"], batch["mel"], train=train,
                        seed=seed, **_model_kwargs(cfg, batch))
    with span("gst.train.loss"):
        return compute_losses(outputs, batch, cfg.loss, cfg.audio,
                              reduction_factor=cfg.model.decoder.reduction_factor,
                              shard=shard)


def train_step(tx: Optimizer, cfg: Config, state: TrainState,
               batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One step on ``state`` in place: teacher-forced forward with the
    BatchNorms' batch statistics (their running buffers move), losses,
    backward, one optimizer update. Returns the loss, its terms and
    ``grad_norm`` (before clipping) as device scalars; the step's gradients
    stay in the parameters' ``.grad`` until the next step."""
    with span("gst.train.step", call=next_call()):
        if "wav" in batch:
            with span("gst.train.features"):
                batch = _materialize_features(cfg, batch)
        model = state.model
        params = sharding.named_parameters(model)
        for p in params.values():
            p.grad = None
        with torch.enable_grad(), sharding.on_mesh(model, state.mesh):
            losses = _forward_losses(cfg, model, batch, train=True,
                                     seed=dropout_seed(state.seed, state.step),
                                     shard=state.data_shard())
            with span("gst.train.backward"):
                losses["loss"].backward()
        with span("gst.train.optimizer"):
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in params.items()}
            metrics = {k: v.detach() for k, v in losses.items()}
            mesh = state.mesh
            if mesh is not None:
                # the global gradient (this rank's block of a sharded
                # kernel's) stays in .grad, as the single-device step leaves it
                grads = sharding.step_gradients(mesh, grads, state.sharded)
                for k, p in params.items():
                    p.grad = grads[k]
                metrics = pmesh.sum_over_data(mesh, metrics)
            metrics["grad_norm"] = tx.update(params, grads, state.opt, state.sharded,
                                             None if mesh is None else mesh.model_sum)
        state.step += 1
        return metrics


def corpus_batch(corpus_wav: torch.Tensor, corpus_ints: torch.Tensor, idx: torch.Tensor,
                 max_text: int, sig_len: int, t_max: int) -> Dict[str, torch.Tensor]:
    """A wav-transport batch gathered from the device corpus: rows ``idx``,
    cut to the bucket's ``sig_len`` samples and ``max_text`` tokens, with
    the 4-scalar block kept from column ``t_max`` (the wire rows bit for
    bit)."""
    rows_i = corpus_ints[idx]
    return {"wav": corpus_wav[idx][:, :sig_len],
            "ints": torch.cat([rows_i[:, :max_text], rows_i[:, t_max:]], 1)}


def train_step_device_corpus(tx: Optimizer, cfg: Config, max_text: int, sig_len: int,
                             t_max: int, state: TrainState, corpus_wav: torch.Tensor,
                             corpus_ints: torch.Tensor, idx: torch.Tensor
                             ) -> Dict[str, torch.Tensor]:
    """The device-corpus step: only ``idx`` ships a step."""
    return train_step(tx, cfg, state, corpus_batch(corpus_wav, corpus_ints, idx,
                                                   max_text, sig_len, t_max))


@torch.no_grad()
def eval_step(cfg: Config, state: TrainState, batch: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """Teacher-forced losses with the running statistics; prenet dropout
    stays on, on its own stream. On the card the GRUs and the reference
    encoder launch their kernels (no grad here)."""
    batch = _materialize_features(cfg, batch)
    with sharding.on_mesh(state.model, state.mesh):
        losses = _forward_losses(cfg, state.model, batch, train=False,
                                 seed=dropout_seed(state.seed, EVAL_STREAM),
                                 shard=state.data_shard())
    return {f"eval_{k}": v for k, v in pmesh.sum_over_data(state.mesh, losses).items()}


def state_dict(state: TrainState) -> Dict[str, Any]:
    """What a checkpoint holds, copied to the host: under a mesh the whole
    state, the sharded kernels and their moments gathered (a collective:
    every rank calls it)."""
    cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}
    if state.mesh is None:
        model, mu, nu = state.model.state_dict(), state.opt.mu, state.opt.nu
    else:
        model = sharding.full_model_state(state.model, state.sharded, state.mesh)
        mu, nu = (sharding.gather_tree(m, state.sharded, state.mesh)
                  for m in (state.opt.mu, state.opt.nu))
    return {"step": state.step, "model": cpu(model),
            "opt": {"count": state.opt.count, "mu": cpu(mu), "nu": cpu(nu)},
            "rng": {"seed": state.seed}}


def save_checkpoint(ckpt: CheckpointManager, state: TrainState) -> None:
    """Rank 0 writes the whole state (``state_dict``, which every rank
    calls); the other ranks wait for it."""
    saved = state_dict(state)
    if pmesh.world()[0] == 0:
        ckpt.save(state.step, saved)
    pmesh.barrier()


def load_state_dict(state: TrainState, saved: Dict[str, Any]) -> None:
    """Restore ``saved`` (a whole state, from any mesh) into ``state``'s
    tensors, in place; under a mesh each sharded kernel and its moments
    take this rank's block. An exported JAX state
    (``checkpoint.read_jax_export``) has no dropout root: ``state`` keeps
    its own (``train.seed``)."""
    if state.mesh is None:
        state.model.load_state_dict(saved["model"])
    else:
        sharding.load_model_state(state.model, saved["model"], state.sharded, state.mesh)
    for name in ("mu", "nu"):
        mine = getattr(state.opt, name)
        theirs = saved["opt"][name]
        if state.mesh is not None:
            theirs = sharding.local_blocks(theirs, state.sharded, state.mesh)
        for k, v in theirs.items():
            mine[k].copy_(v)
    state.opt.count = int(saved["opt"]["count"])
    state.step = int(saved["step"])
    if "rng" in saved:
        state.seed = int(saved["rng"]["seed"])


# ---------------------------------------------------------------------------
# Trainer loop
# ---------------------------------------------------------------------------


class Trainer:
    """Trainer over a pattern directory, on one device or, with ``mesh``, as
    this rank of a data- and tensor-parallel run (every rank constructs its
    ``Trainer`` and steps together). ``device`` is ``cuda`` unless named
    (under a process group, card ``rank % device_count``); with no card and
    no device it raises."""

    def __init__(self, cfg: Config, pattern_dir: str, work_dir: str, device=None,
                 mesh: Optional[pmesh.Mesh] = None):
        self.cfg = cfg
        self.work_dir = work_dir
        self.mesh = mesh
        self.device = pmesh.rank_device(device)
        # rank 0 writes the config, the logs and the checkpoints
        self.chief = pmesh.world()[0] == 0
        os.makedirs(work_dir, exist_ok=True)
        if self.chief:
            save_config(cfg, os.path.join(work_dir, "config.json"))
        if cfg.train.debug_nans:
            torch.autograd.set_detect_anomaly(True)

        self.dataset = PatternDataset(pattern_dir, cfg.data.metadata_file)
        meta_audio = self.dataset.metadata.get("audio", {})
        for key, ours in [("n_fft", cfg.audio.n_fft), ("hop_length", cfg.audio.hop_length),
                          ("sample_rate", cfg.audio.sample_rate),
                          ("num_mels", cfg.audio.num_mels)]:
            theirs = meta_audio.get(key)
            if theirs is not None and theirs != ours:
                raise ValueError(
                    f"pattern corpus was extracted with audio.{key}={theirs} but the "
                    f"training config has {ours}; regenerate patterns or align the config")
        r = cfg.model.decoder.reduction_factor
        shard_index, num_shards = ((0, 1) if mesh is None else
                                   pmesh.process_data_shard(mesh))
        if cfg.data.batch_size % num_shards:
            raise ValueError(f"data.batch_size={cfg.data.batch_size} does not divide over the "
                             f"mesh's data axis of {num_shards} ranks")
        shards = dict(shard_index=shard_index, num_shards=num_shards)
        self.loader = BucketedLoader(self.dataset, cfg.data, r, seed=cfg.train.seed,
                                     audio_cfg=cfg.audio, **shards)
        # held-out eval: teacher-forced losses on a deterministic holdout
        self.val_loader = None
        if cfg.data.val_fraction > 0.0:
            val = BucketedLoader(self.dataset, cfg.data, r, seed=cfg.train.seed, split="val",
                                 drop_remainder=False, audio_cfg=cfg.audio, **shards)
            if any(val.bucket_members):
                self.val_loader = val
        if not self.loader.batches_per_epoch():
            counts = [len(m) for m in self.loader.bucket_members]
            raise ValueError(
                f"loader produced no batches: bucket member counts {counts} for buckets "
                f"{cfg.data.buckets} (batch_size={self.loader.batch_size}); check bucket "
                "bounds vs corpus lengths")
        self.model, self.state = init_state(cfg, self.device)
        if mesh is not None:
            sharding.place_state(self.state, mesh)
            if mesh.shape[pmesh.MODEL_AXIS] > 1:
                tp = {k: v for k, v in sharding.describe_sharding(
                    dict(self.model.named_parameters())).items() if pmesh.MODEL_AXIS in v}
                head = "; ".join(f"{k} -> {v}" for k, v in list(tp.items())[:3])
                print(f"[trainer] tensor-parallel: {len(tp)} param kernels sharded over "
                      f"'model' ({head}; ...)")
        self.tx = make_optimizer(cfg.optimizer)
        self.corpus = None
        if cfg.data.device_corpus:
            if not cfg.data.wav_transport:
                raise ValueError("data.device_corpus requires data.wav_transport=true")
            corpora = self.loader.build_wav_corpus()
            gb = sum(w.nbytes + i.nbytes for w, i in corpora.values()) / 1e9
            if gb > cfg.data.device_corpus_max_gb:
                raise ValueError(
                    f"prepped corpus is {gb:.2f} GB > data.device_corpus_max_gb="
                    f"{cfg.data.device_corpus_max_gb}; lower bucket bounds or disable "
                    "device_corpus")
            # the whole corpus on every rank; each rank's batches index its rows
            self.corpus = {b: (torch.from_numpy(w).to(self.device),
                               torch.from_numpy(i).to(self.device))
                           for b, (w, i) in corpora.items()}
            rows = sum(w.shape[0] for w, _ in corpora.values())
            print(f"[trainer] device corpus resident: {rows} rows in {len(corpora)} "
                  f"bucket array(s), {gb:.2f} GB")
            self.device_corpus_gb = gb
        self.ckpt = CheckpointManager(os.path.join(work_dir, cfg.train.checkpoint_dir),
                                      keep=cfg.train.keep_checkpoints)
        self.logger = MetricLogger(os.path.join(work_dir, "logs") if self.chief else None)

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def step_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One train step on a host batch of the loader (either transport)."""
        return train_step(self.tx, self.cfg, self.state, self._device_batch(batch))

    def step_rows(self, bucket: int, rows: np.ndarray, spec) -> Dict[str, torch.Tensor]:
        """One train step on corpus rows ``rows`` of ``bucket`` (the device
        corpus: only the indices ship)."""
        c_wav, c_ints = self.corpus[bucket]
        sig_len = (spec.max_frames - 1) * self.cfg.audio.hop_length + self.cfg.audio.n_fft
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)
        return train_step_device_corpus(self.tx, self.cfg, spec.max_text, sig_len,
                                        spec.max_text, self.state, c_wav, c_ints, idx)

    def run_eval(self, step: int, max_batches: int = 8) -> Dict[str, float]:
        """Teacher-forced losses over (up to) max_batches held-out batches."""
        sums: Dict[str, float] = {}
        n = 0
        for batch in self.val_loader.epoch(0):
            for k, v in eval_step(self.cfg, self.state, self._device_batch(batch)).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
            if n >= max_batches:
                break
        if not n:
            return {}
        means = {k: v / n for k, v in sums.items()}
        self.logger.write(step, means, prefix="eval")
        return means

    def restore_if_available(self) -> bool:
        """Resume from the latest checkpoint of the workdir: the port's own,
        or a JAX one exported into it by ``tools/export_jax_workdir.py``."""
        step = self.ckpt.latest_step()
        if step is None:
            return False
        load_state_dict(self.state, self.ckpt.restore(step))
        return True

    def train(self, total_steps: Optional[int] = None, eval_fn=None,
              profile_dir: Optional[str] = None, on_step=None) -> TrainState:
        """Steps up to ``total_steps`` (``train.total_steps``), resuming the
        deterministic batch stream at the state's step. ``eval_fn(trainer,
        step)`` runs every ``eval_every`` steps after the held-out eval;
        ``on_step(trainer, step, metrics, frames)`` after every step (frames:
        the batch's bucket length)."""
        cfg = self.cfg
        total = total_steps or cfg.train.total_steps
        start = self.state.step
        if self.corpus is not None:
            it = self.loader.stream_indices(start_batch=start)
        else:
            it = self.loader.stream(start_batch=start)
        t0, window = time.time(), 0
        profiler = StepWindowProfiler(profile_dir)
        try:
            for step in range(start + 1, total + 1):
                profiler.tick()
                if self.corpus is not None:
                    b, rows, spec = next(it)
                    metrics = self.step_rows(b, rows, spec)
                    frames = spec.max_frames
                else:
                    batch = next(it)
                    metrics = self.step_batch(batch)
                    frames = (batch["mel"].shape[1] if "mel" in batch else
                              1 + (batch["wav"].shape[1] - cfg.audio.n_fft)
                              // cfg.audio.hop_length)
                window += 1
                if on_step is not None:
                    on_step(self, step, metrics, frames)
                if step % cfg.train.log_every == 0:
                    # the fetch is the sync point: take dt after it
                    host = {k: float(v) for k, v in metrics.items()}
                    dt = time.time() - t0
                    host["steps_per_sec"] = window / max(dt, 1e-9)
                    self.logger.write(step, host, prefix="train")
                    t0, window = time.time(), 0
                if step % cfg.train.checkpoint_every == 0:
                    save_checkpoint(self.ckpt, self.state)
                if step % cfg.train.eval_every == 0:
                    if self.val_loader is not None:
                        self.run_eval(step)
                    if eval_fn is not None:
                        eval_fn(self, step)
        finally:
            profiler.stop()
            it.close()
        save_checkpoint(self.ckpt, self.state)
        self.ckpt.wait()
        return self.state

    def whole_model(self) -> GSTTacotron:
        """The model with every kernel whole: the state's own model, or under
        a model axis a copy with the shards gathered (a collective: every
        rank calls it)."""
        return sharding.whole_copy(
            self.state.model, self.mesh,
            lambda: build_model(self.cfg, seed=self.cfg.train.seed, device=self.device))


def default_eval_hook(trainer: Trainer, step: int) -> None:
    """Periodic qualitative eval: synthesize ``train.eval_sentences`` through
    the port's ``Synthesizer`` (its kernels on the card), save the wavs and
    alignment PNGs, log diagonality and length, and the first sentence's
    alignment, mel and wav to TensorBoard. In a parallel run rank 0 does it
    (after every rank took part in gathering the sharded kernels)."""
    from .synthesize import Synthesizer

    cfg = trainer.cfg
    model = trainer.whole_model()
    if not trainer.chief:
        return
    synth = Synthesizer(cfg, model, device=trainer.device)
    try:
        out = synth(list(cfg.train.eval_sentences), seed=step)
    except Exception:  # eval must never kill training
        trainer.logger.write(step, {"eval_error": 1.0}, prefix="eval")
        print(f"[eval] synthesis failed at step {step}:")
        traceback.print_exc()
        return
    synth.save_outputs(out, os.path.join(trainer.work_dir, "eval", f"step_{step:08d}"))
    trainer.logger.write(step, {"diagonality": float(np.mean(out["diagonality"])),
                                "mean_frames": float(np.mean(out["frame_lengths"]))},
                         prefix="eval")
    trainer.logger.write_images(step, {"eval/alignment": out["alignments"][0].T,
                                       "eval/mel": out["mel"][0].T})
    n = int(out["wav_lengths"][0])
    trainer.logger.write_audios(step, {"eval/wav": out["wav"][0][:n]},
                                sample_rate=cfg.audio.sample_rate)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train GST-Tacotron (PyTorch port)")
    p.add_argument("--preset", default="taco1_lj")
    p.add_argument("--config", help="config JSON path (overrides preset)")
    p.add_argument("--patterns", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--steps", type=int)
    p.add_argument("--device", default=None,
                   help="default cuda; 'cpu' runs the plain path on the CPU")
    p.add_argument("--model-parallelism", type=int, default=1,
                   help="ranks of the mesh's model axis (tensor parallelism); the data "
                        "axis takes the rest")
    p.add_argument("--coordinator", help="multi-process: host:port of rank 0")
    p.add_argument("--num-processes", type=int, help="multi-process: the number of ranks")
    p.add_argument("--process-id", type=int, help="multi-process: this process's rank")
    p.add_argument("--profile",
                   help="trace ~20 train steps after 2 warm-up steps into this directory")
    p.add_argument("overrides", nargs="*", help="dotted config overrides k=v")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = load_config(args.config) if args.config else get_preset(args.preset)
    if args.overrides:
        cfg = apply_overrides(cfg, parse_cli_overrides(args.overrides))
    with pmesh.cli_mesh(args.model_parallelism, args.coordinator, args.num_processes,
                        args.process_id, args.device) as mesh:
        # unlike the JAX CLI, which drops the mesh where the batch does not
        # divide the data axis, the Trainer raises
        trainer = Trainer(cfg, args.patterns, args.workdir, device=args.device, mesh=mesh)
        trainer.restore_if_available()
        trainer.train(args.steps, eval_fn=default_eval_hook, profile_dir=args.profile)


if __name__ == "__main__":
    main()
