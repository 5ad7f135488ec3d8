"""Training losses (counterpart of ``gst_tacotron_tpu/losses.py``): masked L1
on mel, masked L1 on linear with low-frequency emphasis, stop-token BCE
(masked to the real frames plus ``stop_mask_extra`` when
``loss.stop_masked``) and the optional guided-attention prior. Every term
accumulates in float32.

With a ``DataShard`` (``models.modules``) of a data-parallel step each term
is this rank's numerator over the global batch's denominator (all-reduced,
differentiably, over the data axis): the ranks' terms sum to the term of the
single-process step on the global batch, and so do their gradients. Without
one every term is computed as it is alone."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .config import AudioConfig, LossConfig
from .models.modules import DataShard


def _global(den: torch.Tensor, shard: Optional[DataShard]) -> torch.Tensor:
    """A denominator summed over the data axis (as it is without a shard)."""
    return den if shard is None else shard.all_reduce(den)


def _mean(x: torch.Tensor, shard: Optional[DataShard]) -> torch.Tensor:
    """The mean of ``x`` over the global batch, this rank's share of it."""
    return x.mean() if shard is None else x.sum() / (x.numel() * shard.count)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                shard: Optional[DataShard] = None) -> torch.Tensor:
    """The mean of ``x`` over the cells where ``mask`` (of ``x``'s shape)
    is 1, or over every cell; with ``shard`` this rank's share of the global
    batch's mean."""
    if mask is None:
        return _mean(x, shard)
    return (x * mask).sum() / torch.clamp(_global(mask.sum(), shard), min=1.0)


def sequence_mask(lengths: torch.Tensor, time: int) -> torch.Tensor:
    return (torch.arange(time, device=lengths.device)[None, :]
            < lengths[:, None]).to(torch.float32)


def masked_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: Optional[torch.Tensor], shard: Optional[DataShard] = None) -> torch.Tensor:
    err = torch.abs(pred - target)
    if mask is None:
        return _mean(err, shard)
    m = mask[..., None]
    return (err * m).sum() / torch.clamp(_global(m.sum() * err.shape[-1], shard), min=1.0)


def linear_loss_weights(loss_cfg: LossConfig, audio_cfg: AudioConfig,
                        num_freq: int, device=None) -> torch.Tensor:
    """Per-bin weights: 1 + extra weight below linear_lowfreq_hz, mean 1."""
    freqs = torch.linspace(0.0, audio_cfg.sample_rate / 2.0, num_freq, device=device)
    low = (freqs <= loss_cfg.linear_lowfreq_hz).to(torch.float32)
    w = 1.0 + loss_cfg.linear_lowfreq_weight * low
    return w / w.mean()


def stop_token_targets(mel_lengths: torch.Tensor, time: int) -> torch.Tensor:
    """1.0 at and after each utterance's last frame, else 0."""
    return (torch.arange(time, device=mel_lengths.device)[None, :]
            >= (mel_lengths[:, None] - 1)).to(torch.float32)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE, max(x, 0) - x*z + log1p(exp(-|x|))
    (the JAX package's ``optax_sigmoid_bce``)."""
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))


def guided_attention_loss(alignments: torch.Tensor, token_lengths: torch.Tensor,
                          mel_lengths: torch.Tensor, reduction_factor: int,
                          sigma: float, shard: Optional[DataShard] = None) -> torch.Tensor:
    """W-weighted share of attention mass off the diagonal over (B, S, T)
    alignments: W = 1 - exp(-(t/T_b - s/S_b)^2 / (2 sigma^2)) on the valid
    cells (s < ceil(mel_len / r), t < token_len); sum(A * W) / sum(A)."""
    a = alignments.to(torch.float32)
    _, s_dim, t_dim = a.shape
    dev = a.device
    dec_len = torch.ceil(mel_lengths.to(torch.float32) / reduction_factor)[:, None, None]
    enc_len = token_lengths.to(torch.float32)[:, None, None]
    s = torch.arange(s_dim, dtype=torch.float32, device=dev)[None, :, None]
    t = torch.arange(t_dim, dtype=torch.float32, device=dev)[None, None, :]
    w = 1.0 - torch.exp(-torch.square(t / enc_len - s / dec_len) / (2.0 * sigma * sigma))
    valid = ((s < dec_len) & (t < enc_len)).to(torch.float32)
    return (a * w * valid).sum() / torch.clamp(_global((a * valid).sum(), shard), min=1e-6)


def compute_losses(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                   loss_cfg: LossConfig, audio_cfg: AudioConfig,
                   reduction_factor: Optional[int] = None,
                   shard: Optional[DataShard] = None) -> Dict[str, torch.Tensor]:
    """{"loss", "mel_loss", "linear_loss", "stop_loss"} and, with guided
    attention on, "guided_loss"; with ``shard``, this rank's shares of
    them."""
    outputs = {k: v.to(torch.float32) if torch.is_tensor(v) else v
               for k, v in outputs.items()}
    mel_lengths = batch.get("mel_lengths")
    time = outputs["mel"].shape[1]
    mask = sequence_mask(mel_lengths, time) if mel_lengths is not None else None

    mel_loss = masked_l1(outputs["mel"], batch["mel"], mask, shard)

    wbins = linear_loss_weights(loss_cfg, audio_cfg, outputs["linear"].shape[-1],
                                outputs["linear"].device)
    lin_err = torch.abs(outputs["linear"] - batch["linear"]) * wbins[None, None, :]
    if mask is not None:
        m = mask[..., None]
        linear_loss = (lin_err * m).sum() / torch.clamp(
            _global(m.sum() * lin_err.shape[-1], shard), min=1.0)
    else:
        linear_loss = _mean(lin_err, shard)

    if "stop_logits" in outputs and mel_lengths is not None:
        bce = sigmoid_bce(outputs["stop_logits"], stop_token_targets(mel_lengths, time))
        if loss_cfg.stop_masked:
            smask = sequence_mask(mel_lengths + loss_cfg.stop_mask_extra, time)
            stop_loss = masked_mean(bce, smask, shard)
        else:
            stop_loss = masked_mean(bce, None, shard)
    else:
        stop_loss = outputs["mel"].new_zeros(())

    loss = (loss_cfg.mel_weight * mel_loss + loss_cfg.linear_weight * linear_loss
            + loss_cfg.stop_weight * stop_loss)
    out = {"loss": loss, "mel_loss": mel_loss, "linear_loss": linear_loss,
           "stop_loss": stop_loss}
    if (loss_cfg.guided_attention_weight > 0.0 and "alignments" in outputs
            and mel_lengths is not None and "token_lengths" in batch):
        if reduction_factor is None:
            reduction_factor = max(time // outputs["alignments"].shape[1], 1)
        ga = guided_attention_loss(outputs["alignments"], batch["token_lengths"],
                                   mel_lengths, reduction_factor=reduction_factor,
                                   sigma=loss_cfg.guided_attention_sigma, shard=shard)
        out["guided_loss"] = ga
        out["loss"] = loss + loss_cfg.guided_attention_weight * ga
    return out
