"""A cell at small widths for the CPU tests: the gst_lj (or gst_wavernn)
configuration cut to a few units a layer and a few decoder steps, and a
mix of four short rows."""

from __future__ import annotations

import copy
import time

from gst_tacotron_tpu_torch.config import apply_overrides, get_preset, to_dict

from benchmark import common

SMALL = {
    "audio.n_fft": 512, "audio.hop_length": 128, "audio.win_length": 512,
    "audio.griffin_lim_iters": 3, "model.num_freq": 257,
    "model.encoder.embedding_dim": 32, "model.encoder.prenet_dims": [32, 16],
    "model.encoder.cbhg_bank_k": 4, "model.encoder.cbhg_bank_channels": 8,
    "model.encoder.cbhg_proj_channels": [16, 16], "model.encoder.cbhg_highway_layers": 2,
    "model.encoder.cbhg_highway_dim": 16, "model.encoder.cbhg_gru_dim": 16,
    "model.gst.ref_conv_channels": [4, 4, 8, 8, 8, 8], "model.gst.ref_gru_dim": 16,
    "model.gst.style_dim": 16, "model.gst.num_heads": 2, "model.attention.dim": 16,
    "model.decoder.prenet_dims": [32, 16], "model.decoder.attention_rnn_dim": 16,
    "model.decoder.decoder_rnn_dim": 16, "model.decoder.max_decode_steps": 5,
    "model.decoder.stop_threshold": 1.0, "model.postnet.cbhg_bank_k": 3,
    "model.postnet.cbhg_bank_channels": 8, "model.postnet.cbhg_proj_channels": [16, 80],
    "model.postnet.cbhg_highway_layers": 1, "model.postnet.cbhg_highway_dim": 16,
    "model.postnet.cbhg_gru_dim": 16,
    "model.vocoder.wavernn_gru_dim": 16, "model.vocoder.wavernn_fc_dim": 16,
    "model.vocoder.wavernn_bits": 6, "model.vocoder.wavernn_hop": 128,
}
MIX = {"generator": "synth", "batch": 4, "batches": 2,
       "text_chars": {"median": 30, "sigma": 0.45, "min": 20, "max": 60},
       "ref_seconds": {"min": 0.3, "max": 0.8}}
# CPU runs take the plain float32 routes where the card takes bf16 modes
RUN = {"text_pad_multiple": 32, "ref_mel_bf16": False, "ref_stack_bf16": False}


def config(preset: str = "gst_lj"):
    cfg = apply_overrides(get_preset(preset), SMALL)
    return cfg, {"preset": preset, "run": dict(RUN), "config": to_dict(cfg)}


def context(cell: str = "gst_lj.synth", seed: int = 3, seconds: float = 0.5,
            **workload) -> common.Context:
    wl = copy.deepcopy(common.read_json(common.HERE / "workloads" / f"{cell}.json"))
    wl.update(workload)
    wl["traffic"] = copy.deepcopy(MIX)
    return common.Context(cell=cell, workload=wl, seed=seed, seconds=seconds, trace=False,
                          started=time.time(), device="cpu")

TRAIN_MIX = {"generator": "train", "batch": 4, "batches": 4, "bucket": [16, 20]}


def train_context(seed: int = 5, seconds: float = 0.3) -> common.Context:
    wl = copy.deepcopy(common.read_json(common.HERE / "workloads" / "gst_lj.train.json"))
    wl["traffic"] = dict(TRAIN_MIX)
    return common.Context(cell="gst_lj.train", workload=wl, seed=seed, seconds=seconds,
                          trace=False, started=time.time(), device="cpu")

DP_MIX = {**MIX, "batch": 8}


def dp_context(seed: int = 3, seconds: float = 0.2) -> common.Context:
    wl = copy.deepcopy(common.read_json(common.HERE / "workloads" / "gst_lj.dp4.json"))
    wl["traffic"] = dict(DP_MIX)
    return common.Context(cell="gst_lj.dp4", workload=wl, seed=seed, seconds=seconds,
                          trace=False, started=time.time(), device="cpu", chips=4)
