"""Typed configuration tree of the PyTorch port.

A copy of ``gst_tacotron_tpu/config.py`` (the port imports nothing of the JAX
package): the same dataclasses, JSON load, dotted-path overrides and five
presets, so one config file drives both packages and gives the same dict.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


# ---------------------------------------------------------------------------
# Sound / DSP
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AudioConfig:
    """STFT / mel feature parameters (reference Audio.py semantics).

    The linear spectrogram has ``n_fft // 2 + 1`` bins (1025 for n_fft=2048)
    and the mel spectrogram ``num_mels`` bins, matching the reference's
    1025-linear / 80-mel split (SURVEY.md §2.1 "Audio DSP").
    """

    sample_rate: int = 22050
    preemphasis: float = 0.97
    n_fft: int = 2048
    hop_length: int = 256
    win_length: int = 1024
    num_mels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0
    ref_level_db: float = 20.0
    min_level_db: float = -100.0
    # Symmetric normalization maps dB to [-max_abs_value, max_abs_value];
    # asymmetric (keithito-lineage) maps to [0, 1].
    symmetric_norm: bool = False
    max_abs_value: float = 4.0
    # Griffin-Lim
    griffin_lim_iters: int = 60
    griffin_lim_power: float = 1.5  # magnitude sharpening before inversion
    # Fast-GLA momentum (Perraudin et al. 2013). 0.0 = the reference's plain
    # iteration; ~0.99 halves the iterations needed for the same error.
    griffin_lim_momentum: float = 0.0
    # The JAX package runs the Griffin-Lim iteration transforms in bfloat16
    # when True. The port keeps the key so configs load unchanged, and always
    # iterates in float32 (the JAX behaviour with the flag False).
    griffin_lim_bf16: bool = True
    trim_top_db: float = 60.0  # silence trim threshold at pattern time

    @property
    def num_freq(self) -> int:
        return self.n_fft // 2 + 1


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EncoderConfig:
    """Text encoder (SURVEY.md §2.1 "CBHG", "Tacotron-1 encoder").

    kind selects the reference's Taco_Version switch: "taco1" (prenet+CBHG)
    or "taco2" (conv stack + BiGRU).
    """

    kind: str = "taco1"
    embedding_dim: int = 256
    prenet_dims: Tuple[int, ...] = (256, 128)
    prenet_dropout: float = 0.5
    cbhg_bank_k: int = 16
    cbhg_bank_channels: int = 128
    cbhg_proj_channels: Tuple[int, ...] = (128, 128)
    cbhg_highway_layers: int = 4
    cbhg_highway_dim: int = 128
    cbhg_gru_dim: int = 128  # per direction; encoder output = 2*gru_dim

    @property
    def output_dim(self) -> int:
        return 2 * self.cbhg_gru_dim


@dataclass(frozen=True)
class GSTConfig:
    """Global style tokens (SURVEY.md §2.1 "GST reference encoder", "STL")."""

    enabled: bool = False
    # Reference encoder: 6 x (conv2d 3x3 stride 2x2) + GRU.
    ref_conv_channels: Tuple[int, ...] = (32, 32, 64, 64, 128, 128)
    ref_gru_dim: int = 128
    num_tokens: int = 10
    num_heads: int = 4
    style_dim: int = 256  # style embedding size (attention output)


@dataclass(frozen=True)
class AttentionConfig:
    """Decoder attention. kind in {"bahdanau", "location_sensitive"}."""

    kind: str = "bahdanau"
    dim: int = 256
    # Location-sensitive parameters (SURVEY.md §2.1 "Location-sensitive attention")
    location_filters: int = 32
    location_kernel_size: int = 31
    cumulative: bool = True

    @property
    def location_channels(self) -> int:
        """Channels of the location features: [prev ; cum], or [prev]."""
        return 2 if self.cumulative else 1


@dataclass(frozen=True)
class DecoderConfig:
    """Autoregressive decoder (SURVEY.md §2.1 "Autoregressive decoder")."""

    prenet_dims: Tuple[int, ...] = (256, 128)
    prenet_dropout: float = 0.5
    attention_rnn_dim: int = 256
    decoder_rnn_dim: int = 256
    num_decoder_rnn_layers: int = 2  # residual GRUs
    reduction_factor: int = 2  # r mel frames per decoder step
    max_decode_steps: int = 500  # inference scan length (frames = r * steps)
    use_stop_token: bool = True
    stop_threshold: float = 0.5


@dataclass(frozen=True)
class PostnetConfig:
    """Post-CBHG mel->linear (SURVEY.md §2.1 "Post-net")."""

    cbhg_bank_k: int = 8
    cbhg_bank_channels: int = 128
    cbhg_proj_channels: Tuple[int, ...] = (256, 80)
    cbhg_highway_layers: int = 4
    cbhg_highway_dim: int = 128
    cbhg_gru_dim: int = 128


@dataclass(frozen=True)
class VocoderConfig:
    """Waveform stage: "griffin_lim" or "wavernn" (BASELINE.json config 5)."""

    kind: str = "griffin_lim"
    # WaveRNN-style sampler
    wavernn_gru_dim: int = 512
    wavernn_fc_dim: int = 512
    wavernn_bits: int = 8  # mu-law companded 8-bit output
    wavernn_hop: int = 256  # conditioning upsample factor (== audio hop)


@dataclass(frozen=True)
class ModelConfig:
    num_symbols: int = 0  # filled from the text frontend at build time if 0
    num_speakers: int = 1  # >1 enables speaker-embedding concat (config 4)
    speaker_dim: int = 64
    num_mels: int = 80
    num_freq: int = 1025
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    gst: GSTConfig = field(default_factory=GSTConfig)
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    postnet: PostnetConfig = field(default_factory=PostnetConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    # Compute dtype of the JAX package's matmul-heavy paths; the port's
    # inference path computes in float32.
    compute_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Training / data / runtime
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-3
    # Noam-style: lr * min(step^-0.5, step * warmup^-1.5) * warmup^0.5
    warmup_steps: int = 4000
    schedule: str = "noam"  # "noam" | "constant" | "exponential"
    decay_rate: float = 0.5
    decay_steps: int = 50000
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-6
    grad_clip_norm: float = 1.0
    weight_decay: float = 0.0


@dataclass(frozen=True)
class LossConfig:
    mel_weight: float = 1.0
    linear_weight: float = 1.0
    # keithito-lineage low-frequency emphasis: extra weight on linear bins
    # below ``linear_lowfreq_hz`` (SURVEY.md §2.1 "Loss & optimizer").
    linear_lowfreq_weight: float = 0.5
    linear_lowfreq_hz: float = 3000.0
    stop_weight: float = 1.0
    # Masked stop BCE: average only over frames < mel_length + stop_mask_extra
    # instead of the whole padded bucket — the reference-lineage unmasked mean
    # dilutes the stop transition with pad frames (VERDICT r1).
    stop_masked: bool = False
    stop_mask_extra: int = 10
    # Optional guided-attention prior (Tachibana et al. 2017; NOT in the
    # reference — off by default for training parity): penalizes attention
    # mass far from the diagonal, loss = mean(A * (1 - exp(-(t/T - s/S)^2 /
    # 2 sigma^2))) over valid (decode-step, token) cells.
    guided_attention_weight: float = 0.0
    guided_attention_sigma: float = 0.2


@dataclass(frozen=True)
class DataConfig:
    pattern_dir: str = "patterns"
    metadata_file: str = "metadata.json"
    batch_size: int = 32  # global batch (split over the data mesh axis)
    # Static bucket boundaries: (max_text_len, max_mel_frames) pairs.
    buckets: Tuple[Tuple[int, int], ...] = ((64, 400), (128, 800), (192, 1200))
    min_text_len: int = 2
    max_text_len: int = 192
    max_mel_frames: int = 1200
    shuffle_buffer: int = 2048
    num_workers: int = 2
    prefetch: int = 4
    # Deterministic held-out split: an entry goes to "val" iff
    # md5(entry id) mod 1000 < val_fraction * 1000 (stable across runs/hosts).
    val_fraction: float = 0.0
    # Wav transport: the loader ships preemphasized float16 wav and one
    # packed int32 sidecar a batch, and the features are computed on the
    # device (train._materialize_features). Needs patterns with --store-wav.
    wav_transport: bool = False
    # Device-resident corpus (requires wav_transport): the loader preps it
    # (BucketedLoader.build_wav_corpus); the trainer that holds it on the
    # card is not ported yet.
    device_corpus: bool = False
    device_corpus_max_gb: float = 8.0


@dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 200000
    log_every: int = 50
    checkpoint_every: int = 2000
    eval_every: int = 5000
    keep_checkpoints: int = 5
    checkpoint_dir: str = "checkpoints"
    seed: int = 0
    # NaN-checking debug mode of the JAX trainer.
    debug_nans: bool = False
    eval_sentences: Tuple[str, ...] = (
        "Scientists at the CERN laboratory say they have discovered a new particle.",
        "The quick brown fox jumps over the lazy dog.",
    )


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (SURVEY.md §2.3).

    data axis: utterance-level data parallelism across hosts/chips.
    model axis: tensor parallelism for STL attention / decoder projections.
    """

    data_axis: int = -1  # -1: all remaining devices
    model_axis: int = 1


@dataclass(frozen=True)
class Config:
    name: str = "default"
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


# ---------------------------------------------------------------------------
# JSON load / dump / overrides
# ---------------------------------------------------------------------------


def _from_dict(cls: Any, data: Any) -> Any:
    if dataclasses.is_dataclass(cls) and isinstance(data, dict):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in data.items():
            if key not in fields:
                raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
            ftype = fields[key].type
            sub = _resolve_type(ftype)
            if sub is not None:
                kwargs[key] = _from_dict(sub, value)
            elif isinstance(value, list):
                kwargs[key] = _tuplify(value)
            else:
                kwargs[key] = value
        return cls(**kwargs)
    return data


def _tuplify(value: Any) -> Any:
    if isinstance(value, list):
        return tuple(_tuplify(v) for v in value)
    return value


_TYPE_REGISTRY = {
    "AudioConfig": AudioConfig,
    "EncoderConfig": EncoderConfig,
    "GSTConfig": GSTConfig,
    "AttentionConfig": AttentionConfig,
    "DecoderConfig": DecoderConfig,
    "PostnetConfig": PostnetConfig,
    "VocoderConfig": VocoderConfig,
    "ModelConfig": ModelConfig,
    "OptimizerConfig": OptimizerConfig,
    "LossConfig": LossConfig,
    "DataConfig": DataConfig,
    "TrainConfig": TrainConfig,
    "MeshConfig": MeshConfig,
    "Config": Config,
}


def _resolve_type(ftype: Any) -> Optional[type]:
    name = ftype if isinstance(ftype, str) else getattr(ftype, "__name__", None)
    return _TYPE_REGISTRY.get(name)


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return [to_dict(v) for v in cfg]
    return cfg


def load_config(path: str) -> Config:
    with open(path) as f:
        return _from_dict(Config, json.load(f))


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def apply_overrides(cfg: Config, overrides: dict[str, Any]) -> Config:
    """Apply dotted-path overrides, e.g. {"model.decoder.reduction_factor": 1}."""
    data = to_dict(cfg)
    for path, value in overrides.items():
        node = data
        parts = path.split(".")
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown config path {path!r}")
        node[parts[-1]] = value
    return _from_dict(Config, data)


def parse_cli_overrides(args: list[str]) -> dict[str, Any]:
    """Parse ["a.b=3", "c.d=true", ...] with JSON-typed values."""
    out: dict[str, Any] = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"override must be key=value, got {arg!r}")
        key, _, raw = arg.partition("=")
        try:
            out[key] = json.loads(raw)
        except json.JSONDecodeError:
            out[key] = raw
    return out


# ---------------------------------------------------------------------------
# Presets: the five driver configs (BASELINE.json:7-11)
# ---------------------------------------------------------------------------


# Training and vocoding defaults that the presets ship (held-out split,
# masked stop BCE, fast Griffin-Lim with momentum, guided attention);
# `reference_exact_overrides()` undoes them.
VALIDATED_DEFAULTS = {
    "data.val_fraction": 0.05,
    "loss.stop_masked": True,
    "audio.griffin_lim_momentum": 0.99,
    "audio.griffin_lim_iters": 30,
    "loss.guided_attention_weight": 0.3,
}


def reference_exact_overrides() -> dict:
    """Dotted overrides that undo VALIDATED_DEFAULTS — the reference-exact
    training/vocoding behavior (plain 60-iter Griffin-Lim, unmasked stop
    BCE, no held-out split), for checkpoint-parity experiments."""
    return {
        "data.val_fraction": 0.0,
        "loss.stop_masked": False,
        "audio.griffin_lim_momentum": 0.0,
        "audio.griffin_lim_iters": 60,
        "loss.guided_attention_weight": 0.0,
    }


def preset_taco1_lj() -> Config:
    """Config 1: vanilla Tacotron-1, LJSpeech, Griffin-Lim, CPU-runnable."""
    return apply_overrides(Config(name="taco1_lj"), VALIDATED_DEFAULTS)


def preset_gst_lj() -> Config:
    """Config 2: GST-Tacotron — ref encoder + 10 tokens, 4-head attention."""
    cfg = preset_taco1_lj()
    return apply_overrides(cfg, {"name": "gst_lj", "model.gst.enabled": True})


def preset_gst_r1_location() -> Config:
    """Config 3: r=1 decoding + location-sensitive attention (alignment stress)."""
    cfg = preset_gst_lj()
    return apply_overrides(
        cfg,
        {
            "name": "gst_r1_location",
            "model.attention.kind": "location_sensitive",
            "model.decoder.reduction_factor": 1,
            "model.decoder.max_decode_steps": 1000,
        },
    )


def preset_gst_multispeaker() -> Config:
    """Config 4: multi-speaker GST (VCTK) + speaker embedding, data-parallel."""
    cfg = preset_gst_lj()
    return apply_overrides(
        cfg,
        {
            "name": "gst_multispeaker",
            "model.num_speakers": 109,  # VCTK speaker count
        },
    )


def preset_gst_wavernn() -> Config:
    """Config 5: GST + WaveRNN-style AR sampling vocoder, sharded over hosts."""
    cfg = preset_gst_lj()
    return apply_overrides(cfg, {"name": "gst_wavernn", "model.vocoder.kind": "wavernn"})


PRESETS = {
    "taco1_lj": preset_taco1_lj,
    "gst_lj": preset_gst_lj,
    "gst_r1_location": preset_gst_r1_location,
    "gst_multispeaker": preset_gst_multispeaker,
    "gst_wavernn": preset_gst_wavernn,
}


def get_preset(name: str) -> Config:
    return PRESETS[name]()
