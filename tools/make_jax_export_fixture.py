#!/usr/bin/env python3
"""Regenerate tests/fixtures/jax_export/: a tiny GST-Tacotron trained two
steps by the JAX package's ``Trainer`` on the CPU, exported for the PyTorch
port by ``tools/export_jax_workdir.py``, with the JAX package's own outputs
beside it:

    config.json                     the workdir's config
    checkpoints/step_00000002.npz   the export (variables, Adam state, step)
    expected.npz                    texts, the reference wav, the JAX
                                    ``Synthesizer``'s mel and frame lengths
                                    from the restored state, and the losses
                                    of the JAX ``Trainer``'s next step (3)
                                    resumed from it

The config is ``tests/test_train_smoke.py::small_cfg``'s widths on gst_lj
with the prenet dropout off (the JAX PRNG key is not exported, so a
resumed step agrees only without dropout), the constant schedule at lr 1e-3
and stop threshold 1.5 (every decode step runs). The corpus is
``synthetic_utterances(8)``, which both packages generate alike. The
fixture needs no JAX to read: the port serves and resumes it on the card.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/make_jax_export_fixture.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Any, Dict

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, os.pardir))
sys.path.insert(0, HERE)

FIXTURE_DIR = os.path.join(HERE, os.pardir, "tests", "fixtures", "jax_export")
TEXTS = ["exported from a jax workdir.", "the port serves it on the card."]
STEPS = 2
NUM_UTTERANCES = 8

OVERRIDES = {
    "audio.n_fft": 512, "audio.hop_length": 128, "audio.win_length": 512,
    "audio.griffin_lim_iters": 4, "model.num_freq": 257,
    "model.encoder.embedding_dim": 32, "model.encoder.prenet_dims": [32, 16],
    "model.encoder.cbhg_bank_k": 4, "model.encoder.cbhg_bank_channels": 16,
    "model.encoder.cbhg_proj_channels": [16, 16], "model.encoder.cbhg_highway_layers": 2,
    "model.encoder.cbhg_highway_dim": 16, "model.encoder.cbhg_gru_dim": 16,
    "model.gst.ref_conv_channels": [4, 8, 16], "model.gst.ref_gru_dim": 16,
    "model.gst.style_dim": 16, "model.attention.dim": 16,
    "model.decoder.prenet_dims": [32, 16], "model.decoder.attention_rnn_dim": 16,
    "model.decoder.decoder_rnn_dim": 16, "model.decoder.max_decode_steps": 10,
    "model.postnet.cbhg_bank_k": 2, "model.postnet.cbhg_bank_channels": 8,
    "model.postnet.cbhg_proj_channels": [16, 80], "model.postnet.cbhg_highway_layers": 1,
    "model.postnet.cbhg_highway_dim": 16, "model.postnet.cbhg_gru_dim": 16,
    "data.batch_size": 2, "data.buckets": [[128, 1024]], "data.val_fraction": 0.0,
    "train.log_every": 1, "train.checkpoint_every": 1000, "train.eval_every": 1000,
    "model.encoder.prenet_dropout": 0.0, "model.decoder.prenet_dropout": 0.0,
    "model.decoder.stop_threshold": 1.5,
    "optimizer.schedule": "constant", "optimizer.learning_rate": 1e-3,
}


def fixture_config(**extra):
    from gst_tacotron_tpu.config import apply_overrides, get_preset

    return apply_overrides(get_preset("gst_lj"), {**OVERRIDES, **extra})


def reference_wav(sr: int, seconds: float = 0.4) -> np.ndarray:
    t = np.arange(int(sr * seconds)) / sr
    wav = sum(0.5 ** k * np.sin(2 * np.pi * (k + 1) * 140.0 * t) for k in range(3))
    return (0.3 * wav * (0.6 + 0.4 * np.sin(2 * np.pi * 1.7 * t))).astype(np.float32)


def make_patterns(cfg, out: str) -> str:
    """The JAX package's synthetic corpus of ``NUM_UTTERANCES``."""
    from gst_tacotron_tpu.data import generate_patterns, synthetic_utterances

    generate_patterns(synthetic_utterances(NUM_UTTERANCES, num_speakers=1), cfg.audio, out)
    return out


def train_workdir(cfg, patterns: str, work: str, steps: int = STEPS):
    """A JAX ``Trainer`` run of ``steps`` steps; its workdir holds the
    config and the orbax checkpoint of the last step. Returns the trainer."""
    from gst_tacotron_tpu.train import Trainer

    trainer = Trainer(cfg, patterns, work)
    trainer.train(total_steps=steps)
    return trainer


def jax_reference(cfg, trainer) -> Dict[str, Any]:
    """Through the JAX package, from ``trainer``'s latest orbax checkpoint
    (restored and held bit-equal to the trainer's state, which then goes
    on: a restored state would recompile the step): the ``Synthesizer``'s
    mel and frame lengths on ``TEXTS`` with the reference wav
    (``deterministic_prenet=True``), then the ``Trainer``'s next step (its
    losses, from the metrics log, and the parameters after it). Leaves that
    step's checkpoint in the workdir."""
    import jax

    from gst_tacotron_tpu.synthesize import Synthesizer

    restored = trainer.ckpt.restore(trainer.state)
    same = jax.tree_util.tree_map(lambda a, b: bool(np.array_equal(a, b)),
                                  jax.device_get(restored), jax.device_get(trainer.state))
    if not all(jax.tree_util.tree_leaves(same)):
        raise RuntimeError("the orbax checkpoint differs from the trainer's state")
    step = int(trainer.state.step)
    variables = {"params": trainer.state.params, "batch_stats": trainer.state.batch_stats}
    ref = reference_wav(cfg.audio.sample_rate)
    out = Synthesizer(cfg, trainer.model, variables, deterministic_prenet=True)(
        TEXTS, reference_wavs=[ref, ref], seed=0)
    trainer.train(total_steps=step + 1)
    with open(os.path.join(trainer.work_dir, "logs", "metrics.jsonl")) as f:
        last = [json.loads(line) for line in f][-1]
    if last["step"] != step + 1:
        raise RuntimeError(f"the metrics log ends at step {last['step']}, not {step + 1}")
    losses = {k.split("/", 1)[1]: float(v) for k, v in last.items()
              if k.startswith("train/") and k != "train/steps_per_sec"}
    return {"texts": np.array(TEXTS), "ref_wav": ref, "mel": np.asarray(out["mel"]),
            "frame_lengths": np.asarray(out["frame_lengths"]),
            "next_step": np.asarray(step + 1),
            "next_loss_names": np.array(sorted(losses)),
            "next_losses": np.array([losses[k] for k in sorted(losses)], np.float64),
            "params_after": trainer.state.params,
            "batch_stats_after": trainer.state.batch_stats}


def main() -> None:
    from export_jax_workdir import export

    cfg = fixture_config()
    with tempfile.TemporaryDirectory() as tmp:
        patterns = make_patterns(cfg, os.path.join(tmp, "patterns"))
        trainer = train_workdir(cfg, patterns, os.path.join(tmp, "work"))
        path = export(trainer.work_dir, FIXTURE_DIR)
        ref = jax_reference(cfg, trainer)
    for key in ("params_after", "batch_stats_after"):
        ref.pop(key)
    np.savez(os.path.join(FIXTURE_DIR, "expected.npz"), **ref)
    print(f"wrote {path} and expected.npz")


if __name__ == "__main__":
    main()
