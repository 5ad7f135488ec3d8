"""WaveRNN vocoder trainer (counterpart of ``gst_tacotron_tpu/vocoder_train.py``).

A training stage of its own: patterns generated with ``--store-wav`` are
cropped into fixed-size (mel segment, wav segment) pairs, and the teacher-
forced mu-law cross-entropy (``WaveRNN.loss``) is minimized with the
seq2seq trainer's optimizer chain. The loss is plain PyTorch over the
parameters (no kernel: the sampling kernel K5 serves synthesis only).

Under a mesh (``VocoderTrainer(..., mesh=)``) every rank loads its own
crops (the loader's shard of the corpus, its generator keyed by the shard)
of ``batch_size`` / data ranks rows; the step is the single-device step on
the ranks' rows together: the loss is the rank's share of the global mean,
the gradients are summed over the data axis, and the WaveRNN's ruled
kernels are stored sharded over the model axis (``parallel.sharding``).
Rank 0 writes the logs and the checkpoints (the whole state).

    python -m gst_tacotron_tpu_torch.vocoder_train --patterns P --workdir W
    # N processes, rank i: ... --coordinator HOST:PORT --num-processes N --process-id i
"""

from __future__ import annotations

import argparse
import os
import queue
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .checkpoint import CheckpointManager
from .config import (AudioConfig, Config, apply_overrides, get_preset, load_config,
                     parse_cli_overrides)
from .data.loader import PatternDataset
from .metrics import MetricLogger
from .parallel import mesh as pmesh
from .parallel import sharding
from .train import TrainState, load_state_dict, make_optimizer, save_checkpoint
from .vocoder import check_vocoder_hop
from .weights import build_wavernn


class VocoderSegmentLoader:
    """Yields {mel (B, F, M), wav (B, F*hop)} float16 random crops of fixed
    shape. Usable utterances (longer than ``segment_frames + 2`` frames and
    holding a wav) are decompressed once into a RAM cache as float16 (the
    8-bit mu-law target loses nothing at float16); wav-only shards get their
    mel from the host numpy DSP."""

    def __init__(self, dataset: PatternDataset, hop: int, *, segment_frames: int = 24,
                 batch_size: int = 16, seed: int = 0, shard_index: int = 0,
                 num_shards: int = 1):
        self.ds = dataset
        self.hop = hop
        self.segment_frames = segment_frames
        self.batch_size = batch_size
        self.rng = np.random.default_rng((seed, shard_index))
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._audio_cfg = None
        # entries without has_wav (older pattern dirs) are probed here, up
        # front, never mid-training
        self.usable = []
        for i, e in enumerate(dataset.entries):
            if e["mel_len"] <= segment_frames + 2:
                continue
            has_wav = e.get("has_wav")
            if has_wav is None:
                has_wav = "wav" in dataset.load(i)
            if has_wav:
                self.usable.append(i)
        self.usable = self.usable[shard_index::num_shards] or self.usable
        if not self.usable:
            raise ValueError("no usable utterances for vocoder training; patterns must be "
                             "generated with --store-wav and exceed segment_frames")
        self.num_mels = int(self._get(self.usable[0])[0].shape[1])

    def _get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        hit = self._cache.get(idx)
        if hit is None:
            item = self.ds.load(idx)
            if "mel" not in item:
                from .dsp import ref as dsp_ref

                if self._audio_cfg is None:
                    meta = self.ds.metadata.get("audio", {})
                    self._audio_cfg = AudioConfig(**{
                        k: v for k, v in meta.items() if k in AudioConfig.__dataclass_fields__})
                mel = dsp_ref.melspectrogram(np.asarray(item["wav"], np.float64),
                                             self._audio_cfg)
            else:
                mel = item["mel"]
            hit = (mel.astype(np.float16), item["wav"].astype(np.float16))
            self._cache[idx] = hit
        return hit

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        f = self.segment_frames
        while True:
            mel_b = np.zeros((self.batch_size, f, self.num_mels), np.float16)
            wav_b = np.zeros((self.batch_size, f * self.hop), np.float16)
            for j in range(self.batch_size):
                mel, wav = self._get(int(self.rng.choice(self.usable)))
                max_start = min(mel.shape[0] - f, (len(wav) - f * self.hop) // self.hop)
                start = int(self.rng.integers(0, max(1, max_start)))
                mel_b[j] = mel[start: start + f]
                seg = wav[start * self.hop: (start + f) * self.hop]
                wav_b[j, : len(seg)] = seg
            yield {"mel": mel_b, "wav": wav_b}


class VocoderTrainer:
    """``device`` is ``cuda`` unless named (under a process group, card
    ``rank % device_count``); with no card and no device it raises.
    ``batch_size`` is the global batch; with ``mesh`` this rank's share."""

    def __init__(self, cfg: Config, pattern_dir: str, work_dir: str, device=None,
                 segment_frames: int = 24, batch_size: int = 16,
                 mesh: Optional[pmesh.Mesh] = None):
        check_vocoder_hop(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.device = pmesh.rank_device(device)
        self.chief = pmesh.world()[0] == 0
        os.makedirs(work_dir, exist_ok=True)
        shard_index, num_shards = (0, 1) if mesh is None else pmesh.process_data_shard(mesh)
        if batch_size % num_shards:
            raise ValueError(f"batch_size={batch_size} does not divide over the mesh's data "
                             f"axis of {num_shards} ranks")
        ds = PatternDataset(pattern_dir, cfg.data.metadata_file)
        self.loader = VocoderSegmentLoader(ds, cfg.model.vocoder.wavernn_hop,
                                           segment_frames=segment_frames,
                                           batch_size=batch_size // num_shards,
                                           seed=cfg.train.seed, shard_index=shard_index,
                                           num_shards=num_shards)
        self.model = build_wavernn(cfg, seed=cfg.train.seed, device=self.device)
        self.tx = make_optimizer(cfg.optimizer)
        self.state = TrainState(0, self.model,
                                self.tx.init(dict(self.model.named_parameters())),
                                cfg.train.seed + 1)
        if mesh is not None:
            sharding.place_state(self.state, mesh)
        self.ckpt = CheckpointManager(os.path.join(work_dir, "vocoder_ckpt"),
                                      keep=cfg.train.keep_checkpoints)
        self.logger = MetricLogger(os.path.join(work_dir, "vocoder_logs")
                                   if self.chief else None)

    def restore_if_available(self) -> bool:
        """Resume from the latest ``vocoder_ckpt/`` checkpoint: the port's
        own, or a JAX one exported by ``tools/export_jax_workdir.py
        --vocoder``."""
        step = self.ckpt.latest_step()
        if step is None:
            return False
        load_state_dict(self.state, self.ckpt.restore(step))
        return True

    def step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One update on a float16 host batch (computed in float32)."""
        mel, wav = (torch.from_numpy(batch[k]).to(self.device, torch.float32)
                    for k in ("mel", "wav"))
        params = sharding.named_parameters(self.model)
        mesh = self.mesh
        with torch.enable_grad(), sharding.on_mesh(self.model, mesh):
            loss = self.model.loss(mel, wav)
            loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        grads = sharding.step_gradients(mesh, grads, self.state.sharded)
        loss = pmesh.sum_over_data(mesh, {"loss": loss.detach()})["loss"]
        grad_norm = self.tx.update(params, grads, self.state.opt, self.state.sharded,
                                   None if mesh is None else mesh.model_sum)
        for p in params.values():
            p.grad = None
        self.state.step += 1
        return {"loss": loss, "grad_norm": grad_norm}

    def train(self, total_steps: int) -> TrainState:
        """Steps up to ``total_steps``; batches are assembled on a feeder
        thread, a bounded queue ahead of the steps."""
        start = self.state.step
        todo = max(0, total_steps - start)
        q: queue.Queue = queue.Queue(maxsize=4)

        def feed():
            it = iter(self.loader)
            for _ in range(todo):
                q.put(next(it))

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        t0, window = time.time(), 0
        for step in range(start + 1, total_steps + 1):
            metrics = self.step(q.get())
            window += 1
            if step % self.cfg.train.log_every == 0:
                loss = float(metrics["loss"])
                dt = time.time() - t0
                self.logger.write(step, {"loss": loss,
                                         "steps_per_sec": window / max(dt, 1e-9)},
                                  prefix="vocoder")
                t0, window = time.time(), 0
            if step % self.cfg.train.checkpoint_every == 0:
                save_checkpoint(self.ckpt, self.state)
        feeder.join()
        save_checkpoint(self.ckpt, self.state)
        self.ckpt.wait()
        return self.state


def main(argv=None):
    p = argparse.ArgumentParser(description="Train the WaveRNN vocoder stage (PyTorch port)")
    p.add_argument("--preset", default="gst_wavernn")
    p.add_argument("--config")
    p.add_argument("--patterns", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--segment-frames", type=int, default=24)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="default cuda; 'cpu' runs the plain path on the CPU")
    p.add_argument("--model-parallelism", type=int, default=1)
    p.add_argument("--coordinator", help="multi-process: host:port of rank 0")
    p.add_argument("--num-processes", type=int, help="multi-process: the number of ranks")
    p.add_argument("--process-id", type=int, help="multi-process: this process's rank")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    cfg = load_config(args.config) if args.config else get_preset(args.preset)
    if args.overrides:
        cfg = apply_overrides(cfg, parse_cli_overrides(args.overrides))
    with pmesh.cli_mesh(args.model_parallelism, args.coordinator, args.num_processes,
                        args.process_id, args.device) as mesh:
        trainer = VocoderTrainer(cfg, args.patterns, args.workdir, device=args.device,
                                 segment_frames=args.segment_frames,
                                 batch_size=args.batch_size, mesh=mesh)
        trainer.restore_if_available()
        trainer.train(args.steps)


if __name__ == "__main__":
    main()
