"""The alignment gate (counterpart of ``tests/test_alignment_gate.py``).

Trains config 3 (location-sensitive attention, r=1) with the port's
``Trainer`` on a token-pattern corpus in which each token emits one frame
of a fixed token-specific spectral pattern: the previous frame never
predicts the next, so attending to the right encoder position is the only
way to lower the loss. A working attention learns a clearly diagonal
alignment within ``GATE_STEPS`` steps; a broken one stays near the
uniform-attention floor (~0.41 at these lengths). The gate: the
teacher-forced diagonality on the loader's first batch ends above
``GATE_THRESHOLD`` and more than ``GATE_MARGIN`` above the untrained
model's.

It runs on the card (``tests/test_torch_cuda.py::test_alignment_gate_on_the_card``)
unless ``device="cpu"`` is passed:

    from gst_tacotron_tpu_torch.alignment_gate import gate_failures, run_gate
    result = run_gate("/tmp/gate")
    assert not gate_failures(result)
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

from .config import Config, apply_overrides, get_preset
from .data.pattern import Utterance, write_pattern
from .device import resolve_device
from .models.attention import alignment_diagonality
from .text import NUM_SYMBOLS
from .train import Trainer

GATE_STEPS = 800
GATE_THRESHOLD = 0.85
GATE_MARGIN = 0.3


def gate_config() -> Config:
    """The JAX gate's overrides of gst_r1_location: narrow widths, GST off
    (its target-mel conditioning is a content shortcut on a corpus this
    small), prenet dropout off, one bucket of 32 tokens and 64 frames."""
    ov = {
        "audio.n_fft": 512, "audio.hop_length": 128, "audio.win_length": 512,
        "audio.num_mels": 16,
        "model.num_mels": 16, "model.num_freq": 33,
        "model.encoder.embedding_dim": 64,
        "model.encoder.prenet_dims": [64, 32],
        "model.encoder.prenet_dropout": 0.0,
        "model.encoder.cbhg_bank_k": 4,
        "model.encoder.cbhg_bank_channels": 32,
        "model.encoder.cbhg_proj_channels": [32, 32],
        "model.encoder.cbhg_highway_layers": 2,
        "model.encoder.cbhg_highway_dim": 32,
        "model.encoder.cbhg_gru_dim": 32,
        "model.gst.enabled": False,
        "model.attention.dim": 32,
        "model.attention.location_filters": 8,
        "model.attention.location_kernel_size": 15,
        "model.decoder.prenet_dims": [64, 32],
        "model.decoder.prenet_dropout": 0.0,
        "model.decoder.attention_rnn_dim": 32,
        "model.decoder.decoder_rnn_dim": 32,
        "model.postnet.cbhg_bank_k": 2,
        "model.postnet.cbhg_bank_channels": 8,
        "model.postnet.cbhg_proj_channels": [16, 16],
        "model.postnet.cbhg_highway_layers": 1,
        "model.postnet.cbhg_highway_dim": 16,
        "model.postnet.cbhg_gru_dim": 16,
        "data.batch_size": 8, "data.buckets": [[32, 64]],
        "optimizer.learning_rate": 1e-3, "optimizer.warmup_steps": 200,
        "loss.stop_masked": True, "loss.linear_weight": 0.0,
        "train.log_every": 100000, "train.checkpoint_every": 10 ** 7,
        "train.eval_every": 10 ** 8,
    }
    cfg = apply_overrides(get_preset("gst_r1_location"), ov)
    assert cfg.model.decoder.reduction_factor == 1
    assert cfg.model.attention.kind == "location_sensitive"
    return cfg


def write_token_pattern_corpus(cfg: Config, out_dir: str, n: int = 32, seed: int = 0) -> None:
    """``n`` utterances of 10-24 tokens, one frame per token; a frame is the
    token's fixed random pattern plus a little noise (the JAX gate's
    corpus, drawn in its order)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    emb = rng.uniform(0.1, 0.9, (NUM_SYMBOLS, cfg.model.num_mels)).astype(np.float32)
    entries = []
    for i in range(n):
        n_tok = int(rng.integers(10, 25))
        toks = rng.integers(2, NUM_SYMBOLS, n_tok).astype(np.int32)
        mel = emb[toks]
        mel = np.clip(mel + 0.02 * rng.standard_normal(mel.shape), 0, 1).astype(np.float32)
        lin = np.zeros((mel.shape[0], cfg.model.num_freq), np.float32)
        u = Utterance(f"tp_{i:03d}", "x", None, "S0", 0)
        entries.append(write_pattern(u, toks, np.zeros(512, np.float32), mel, lin, out_dir,
                                     False))
    meta = {
        "audio": {"sample_rate": cfg.audio.sample_rate, "n_fft": cfg.audio.n_fft,
                  "hop_length": cfg.audio.hop_length, "num_mels": cfg.model.num_mels},
        "num_speakers": 1, "speakers": ["S0"], "entries": entries,
    }
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)


@torch.no_grad()
def teacher_forced_diagonality(trainer: Trainer, batch: Dict[str, torch.Tensor]) -> float:
    """Mean diagonality of the teacher-forced alignments of a device batch,
    the model in inference mode (running statistics)."""
    out = trainer.state.model(batch["tokens"], batch["token_lengths"], batch["mel"],
                              train=False)
    r = trainer.cfg.model.decoder.reduction_factor
    diag = alignment_diagonality(out["alignments"], batch["token_lengths"],
                                 torch.clamp(batch["mel_lengths"] // r, min=1))
    return float(diag.mean())


@dataclass
class GateResult:
    untrained: float
    trained: float
    loss: float
    steps: int
    seconds: float            # the steps' wall time, a synchronize at its end
    trainer: Trainer
    probe: Dict[str, torch.Tensor]   # the device batch the diagonality reads

    def summary(self) -> Dict[str, Any]:
        return {"untrained_diagonality": self.untrained, "trained_diagonality": self.trained,
                "loss": self.loss, "steps": self.steps, "train_seconds": self.seconds,
                "ms_per_step": 1e3 * self.seconds / max(self.steps, 1),
                "threshold": GATE_THRESHOLD, "margin": GATE_MARGIN}


def run_gate(work_dir: str, device=None, steps: int = GATE_STEPS) -> GateResult:
    """Write the corpus under ``work_dir``, build the ``Trainer`` over it
    (``cuda`` unless ``device`` names another), read the untrained
    diagonality on the loader's first batch, take ``steps`` train steps on
    the batches after it, and read the diagonality again."""
    dev = resolve_device(device)
    cfg = gate_config()
    patterns = os.path.join(work_dir, "patterns")
    write_token_pattern_corpus(cfg, patterns)
    trainer = Trainer(cfg, patterns, os.path.join(work_dir, "work"), device=dev)
    it = iter(trainer.loader)
    try:
        probe = trainer._device_batch(next(it))
        untrained = teacher_forced_diagonality(trainer, probe)
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = trainer.step_batch(next(it))
        loss = float(metrics["loss"])     # the sync point: every step feeds the next
        seconds = time.perf_counter() - t0
    finally:
        it.close()
    trained = teacher_forced_diagonality(trainer, probe)
    return GateResult(untrained, trained, loss, steps, seconds, trainer, probe)


def gate_failures(result: GateResult) -> List[str]:
    """The gate's conditions that ``result`` breaks (none: it passed)."""
    bad = []
    if not np.isfinite(result.loss):
        bad.append(f"loss {result.loss} is not finite")
    if not result.trained > GATE_THRESHOLD:
        bad.append(f"attention diagonality regressed: {result.trained:.4f} <= "
                   f"{GATE_THRESHOLD} after {result.steps} steps "
                   f"(untrained {result.untrained:.4f})")
    if not result.trained - result.untrained > GATE_MARGIN:
        bad.append(f"training did not improve alignment: {result.untrained:.4f} -> "
                   f"{result.trained:.4f} (margin {GATE_MARGIN})")
    return bad
