"""Plain GST-Tacotron training steps from a configuration dict, a weights
dict and feature batches.

A frozen copy of the training step's math in plain torch with autograd:
the teacher-forced forward with the BatchNorms' batch statistics (the
statistics over every axis but the channels, padded positions included,
variance E[x^2] - E[x]^2), the style from the target mel itself, the
prenets' dropout (the encoder's from a torch generator on the device
seeded with the step's dropout seed, the decoder's from the Philox streams
under that seed plus one), the post-net over every frame; the losses
(masked L1 on mel, masked L1 on linear with the low-frequency weight, the
masked stop BCE, guided attention); then optax's chain: clip by global
norm, Adam with eps outside the root and bias correction, the noam
schedule. BatchNorm's running statistics move by 0.99 each step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import tacotron
from .tacotron import W, dense, gru, mask

BN_MOMENTUM = 0.99


class Stats:
    """The BatchNorms' running statistics, moved as the step moves them."""

    def __init__(self, w: W):
        self.w = w

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
        with torch.no_grad():
            for key, v in (("mean", mean), ("var", var)):
                k = f"{name}.{key}"
                self.w[k] = BN_MOMENTUM * self.w[k] + (1 - BN_MOMENTUM) * v.detach()
        mul = torch.rsqrt(var + tacotron.BN_EPS) * self.w[f"{name}.scale"]
        return (x - mean) * mul + self.w[f"{name}.bias"]


def _style(w: W, bn: Stats, mel: torch.Tensor, lengths: torch.Tensor, g: dict) -> torch.Tensor:
    n = len(g["ref_conv_channels"])
    x = mask(mel, lengths)[..., None]
    for i in range(n):
        x = tacotron.conv2d_stride2_same(x, w[f"gst.reference_encoder.conv_{i}.kernel"])
        x = torch.relu(bn.norm(f"gst.reference_encoder.bn_{i}", x))
    b, t, f, c = x.shape
    steps = torch.clamp((lengths + 2 ** n - 1) // 2 ** n, min=1)
    _, ref = gru(w, "gst.reference_encoder.gru", x.reshape(b, t, f * c), steps)
    heads, dim = g["num_heads"], g["style_dim"] // g["num_heads"]
    keys_base = torch.tanh(w["gst.stl.tokens"])
    q = (ref @ w["gst.stl.query_proj.kernel"]).reshape(b, heads, dim)
    k = (keys_base @ w["gst.stl.key_proj.kernel"]).reshape(-1, heads, dim)
    v = (keys_base @ w["gst.stl.value_proj.kernel"]).reshape(-1, heads, dim)
    attn = torch.softmax(torch.einsum("bhd,nhd->bhn", q, k) / np.sqrt(dim), -1)
    return torch.einsum("bhn,nhd->bhd", attn, v).reshape(b, g["style_dim"])


def forward(w: W, cfg: dict, batch: Dict[str, torch.Tensor], seed: int) -> Dict[str, torch.Tensor]:
    m = cfg["model"]
    e = m["encoder"]
    bn = Stats(w)
    tok, tok_len = batch["tokens"].long(), batch["token_lengths"].long()
    mel_t, mel_len = batch["mel"], batch["mel_lengths"].long()
    gen = torch.Generator(device=tok.device)
    gen.manual_seed(seed)
    x = w["encoder.embedding.embedding"][tok]
    x = tacotron.prenet(w, "encoder.prenet", x, len(e["prenet_dims"]), e["prenet_dropout"], gen)
    enc = mask(tacotron.cbhg(w, "encoder.cbhg", x, tok_len, e, bn.norm), tok_len)
    style = _style(w, bn, mel_t, mel_len, m["gst"])
    t = enc.shape[1]
    memory = torch.cat([enc, style[:, None, :].expand(-1, t, -1)], -1)
    steps = mel_t.shape[1] // m["decoder"]["reduction_factor"]
    mel, stops, aligns = tacotron.decode(w, memory, tok_len, m, steps, seed + 1, fed=mel_t)
    lin = dense(w, "postnet.linear_proj", tacotron.cbhg(w, "postnet.cbhg", mel, None, m["postnet"], bn.norm))
    return {"mel": mel, "linear": lin, "stop_logits": stops, "alignments": aligns}


def losses(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], cfg: dict
           ) -> Dict[str, torch.Tensor]:
    lc, a, m = cfg["loss"], cfg["audio"], cfg["model"]
    mel_len = batch["mel_lengths"].long()
    time = out["mel"].shape[1]
    seq = lambda n: (torch.arange(time, device=n.device)[None, :] < n[:, None]).float()
    msk = seq(mel_len)[..., None]
    mel_l = (torch.abs(out["mel"] - batch["mel"]) * msk).sum() / torch.clamp(
        msk.sum() * out["mel"].shape[-1], min=1.0)
    nf = out["linear"].shape[-1]
    freqs = torch.linspace(0.0, a["sample_rate"] / 2.0, nf, device=mel_len.device)
    wb = 1.0 + lc["linear_lowfreq_weight"] * (freqs <= lc["linear_lowfreq_hz"]).float()
    wb = wb / wb.mean()
    lin_l = (torch.abs(out["linear"] - batch["linear"]) * wb * msk).sum() / torch.clamp(
        msk.sum() * nf, min=1.0)
    z = (torch.arange(time, device=mel_len.device)[None, :] >= (mel_len[:, None] - 1)).float()
    x = out["stop_logits"]
    bce = torch.clamp(x, min=0.0) - x * z + torch.log1p(torch.exp(-torch.abs(x)))
    smask = seq(mel_len + lc["stop_mask_extra"]) if lc["stop_masked"] else torch.ones_like(bce)
    stop_l = (bce * smask).sum() / torch.clamp(smask.sum(), min=1.0)
    loss = lc["mel_weight"] * mel_l + lc["linear_weight"] * lin_l + lc["stop_weight"] * stop_l
    res = {"mel_loss": mel_l, "linear_loss": lin_l, "stop_loss": stop_l}
    if lc["guided_attention_weight"] > 0:
        al = out["alignments"]
        _, s_dim, t_dim = al.shape
        dec = torch.ceil(mel_len.float() / m["decoder"]["reduction_factor"])[:, None, None]
        enc = batch["token_lengths"].float()[:, None, None]
        s = torch.arange(s_dim, device=al.device, dtype=torch.float32)[None, :, None]
        t = torch.arange(t_dim, device=al.device, dtype=torch.float32)[None, None, :]
        sig = lc["guided_attention_sigma"]
        wg = 1.0 - torch.exp(-torch.square(t / enc - s / dec) / (2.0 * sig * sig))
        valid = ((s < dec) & (t < enc)).float()
        ga = (al * wg * valid).sum() / torch.clamp((al * valid).sum(), min=1e-6)
        res["guided_loss"] = ga
        loss = loss + lc["guided_attention_weight"] * ga
    res["loss"] = loss
    return res


def dropout_seed(seed: int, step: int) -> int:
    """The step's dropout seed: the run's seed in the high 32 bits, the step
    in the low."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def noam(o: dict, count: int) -> float:
    step = np.float32(max(count, 1))
    w = float(o["warmup_steps"])
    return float(np.float32(o["learning_rate"] * w ** 0.5)
                 * np.minimum(step * np.float32(w ** -1.5), np.float32(1.0 / np.sqrt(float(step)))))


def steps(w: W, params: List[str], cfg: dict, batches: List[Dict[str, torch.Tensor]],
          seed: int, start: Optional[Tuple[int, W, W]] = None) -> Dict[str, object]:
    """Run the steps of ``batches`` from the weights ``w`` (moved in place)
    and Adam's ``start`` state (the update count, first and second
    moments; none: the first step). Returns each step's loss terms, the
    first step's clipped gradient of each parameter as Adam takes it, and
    the final parameters."""
    o = cfg["optimizer"]
    if start is None:
        start = (0, {k: torch.zeros_like(w[k]) for k in params},
                 {k: torch.zeros_like(w[k]) for k in params})
    first, mu, nu = start[0], dict(start[1]), dict(start[2])
    out: Dict[str, object] = {"losses": [], "first_grads": None}
    for count, batch in enumerate(batches, first):
        leaves = {k: w[k].detach().requires_grad_(True) for k in params}
        w.update(leaves)
        terms = losses(forward(w, cfg, batch, dropout_seed(seed, count)), batch, cfg)
        grads = torch.autograd.grad(terms["loss"], [leaves[k] for k in params],
                                    allow_unused=True)
        g = {k: torch.zeros_like(w[k]) if gr is None else gr for k, gr in zip(params, grads)}
        out["losses"].append({k: float(v.detach()) for k, v in terms.items()})
        with torch.no_grad():
            norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
            if not norm < o["grad_clip_norm"]:
                g = {k: (x / norm) * o["grad_clip_norm"] for k, x in g.items()}
            if out["first_grads"] is None:
                out["first_grads"] = {k: x.clone() for k, x in g.items()}
            c = count + 1
            bc1, bc2 = 1 - np.float32(o["beta1"]) ** c, 1 - np.float32(o["beta2"]) ** c
            lr = noam(o, count)
            for k in params:
                mu[k] = (1 - o["beta1"]) * g[k] + o["beta1"] * mu[k]
                nu[k] = (1 - o["beta2"]) * (g[k] * g[k]) + o["beta2"] * nu[k]
                u = (mu[k] / float(bc1)) / (torch.sqrt(nu[k] / float(bc2)) + o["eps"])
                if o["weight_decay"] > 0:
                    u = u + o["weight_decay"] * w[k]
                w[k] = (w[k] - lr * u).detach()
    out["params"] = {k: w[k] for k in params}
    return out
