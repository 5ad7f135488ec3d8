"""Shared modules: dense, BatchNorm, prenet, highway, convs, CBHG, the Taco2
conv stack.

Counterparts of ``gst_tacotron_tpu/models/modules.py``. Parameters keep the
JAX package's names and layouts (``kernel`` is (in, out), conv kernels are
(k, in, out) or (3, 3, in, out), BatchNorm has ``scale``/``bias`` parameters
and ``mean``/``var`` buffers), so ``weights.py`` maps a flax path onto a
state-dict key one to one. Sequence tensors are (B, T, C). Padded positions
are re-zeroed before every conv, as in the JAX package. ``train=True``
normalizes with the batch's statistics and updates the running ones, as
flax's ``BatchNorm(use_running_average=False)`` in a mutable step.

``compute_dtype`` is flax's ``dtype`` field (``model.compute_dtype``): the
parameters stay float32 and each module casts its operands to it where the
flax module does (``set_compute_dtype`` sets it on a model's every module).

``data_parallel(model, shard)`` makes a model's modules compute one rank's
share of a global batch (``DataShard``) as the single-process model computes
the whole batch: BatchNorm takes the global batch's statistics (the sums
all-reduced over the data axis, differentiably), and dropout draws the mask
of the global batch's shape and keeps the rank's rows. The decoder and the
WaveRNN sampler read the shard for their Philox streams' first row. With no
shard, or a data axis of one rank, every module computes what it computes
alone.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Keras BatchNormalization epsilon (flax's default is 1e-5).
BN_EPS = 1e-3
# flax's BatchNorm momentum: running = 0.99 * running + 0.01 * batch
BN_MOMENTUM = 0.99


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make every module of ``model`` compute in ``dtype``; parameters stay
    float32 (flax's ``dtype`` against ``param_dtype``)."""
    for m in model.modules():
        m.compute_dtype = dtype
    return model


def compute_dtype(module: nn.Module) -> torch.dtype:
    return getattr(module, "compute_dtype", torch.float32)


class DataShard(NamedTuple):
    """Shard ``index`` of ``count`` equal shards of a global batch, and the
    differentiable sum over the ranks that hold them (``parallel.Mesh
    .data_shard``)."""
    index: int
    count: int
    all_reduce: Callable[[torch.Tensor], torch.Tensor]

    def row0(self, rows: int) -> int:
        """The global index of the first of this shard's ``rows`` rows."""
        return self.index * rows


@contextlib.contextmanager
def data_parallel(model: nn.Module, shard: Optional[DataShard]) -> Iterator[nn.Module]:
    """Within the block, ``model``'s modules compute ``shard``'s rows of a
    global batch (see the module docstring); None changes nothing."""
    if shard is None:
        yield model
        return
    for m in model.modules():
        m.data_shard = shard
    try:
        yield model
    finally:
        for m in model.modules():
            del m.data_shard


def data_shard(module: nn.Module) -> Optional[DataShard]:
    """The shard ``module`` computes under ``data_parallel``; None when it
    computes the whole batch."""
    return getattr(module, "data_shard", None)


def shard_row0(module: nn.Module, rows: int) -> int:
    """The global index of the first of ``rows`` rows that ``module``
    computes (0 outside ``data_parallel``)."""
    shard = data_shard(module)
    return 0 if shard is None else shard.row0(rows)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``. In float32 ``torch.sigmoid``; in a 16-bit dtype
    XLA computes it as 1 / (1 + exp(-x)) with each operation rounded to that
    dtype, and so does this (one rounding would part from it by an ulp at a
    fifth of the values)."""
    if x.dtype in (torch.float32, torch.float64):
        return torch.sigmoid(x)
    return 1.0 / (torch.exp(-x) + 1.0)


def length_mask(lengths: torch.Tensor, time: int) -> torch.Tensor:
    """(B,) -> (B, T) boolean validity mask."""
    return torch.arange(time, device=lengths.device)[None, :] < lengths[:, None]


def mask_sequence(xs: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    if lengths is None:
        return xs
    return xs * length_mask(lengths.to(xs.device), xs.shape[1])[..., None].to(xs.dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            shard: Optional[DataShard] = None) -> torch.Tensor:
    """Inverted dropout drawn from ``generator`` (flax ``nn.Dropout``); a
    ``shard`` of a global batch draws the global batch's mask and keeps its
    rows."""
    if shard is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        b = x.shape[0]
        u = torch.rand((shard.count * b,) + tuple(x.shape[1:]), generator=generator,
                       device=x.device)[shard.row0(b): shard.row0(b) + b]
    keep = u >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dense(nn.Module):
    """y = x @ kernel (+ bias); kernel (in, out) as flax ``nn.Dense``."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self)
        y = x.to(dt) @ self.kernel.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


class Embed(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding.to(compute_dtype(self))[ids]


class BatchNorm(nn.Module):
    """BatchNorm over the last axis in flax's order: (x - mean) * (scale *
    rsqrt(var + eps)) + bias. Inference takes the running statistics.
    ``train=True`` takes the batch's, over every axis but the last (padded
    positions included, as flax), with flax 0.12's fast variance E[x^2] -
    E[x]^2 clipped at 0 (biased), and moves the running buffers by
    ``BN_MOMENTUM``. Under ``data_parallel`` the statistics are the global
    batch's: the per-channel sums of x and x^2 all-reduced over the data
    axis before the division (the backward passes through the sum), so
    every rank moves its buffers alike. Statistics and the normalization run
    in float32 (at least); the result is cast to the compute dtype. Not
    ``nn.BatchNorm`` (nor ``nn.SyncBatchNorm``): its momentum weighs the
    other way and its running variance is unbiased."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            mean, var = self.mean, self.var
        else:
            axes = tuple(range(x.dim() - 1))
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            shard = data_shard(self)
            if shard is None:
                mean = xf.mean(axes)
                var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            else:
                c = xf.shape[-1]
                n = xf.numel() // c * shard.count
                sums = shard.all_reduce(torch.cat([xf.sum(axes), (xf * xf).sum(axes)]))
                mean = sums[:c] / n
                var = torch.clamp(sums[c:] / n - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x - mean) * mul + self.bias).to(compute_dtype(self))


class Prenet(nn.Module):
    """FC stack with dropout that stays on at inference unless
    ``deterministic`` (the Tacotron trait)."""

    def __init__(self, in_dim: int, layer_dims: Sequence[int], dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.num_layers = len(layer_dims)
        for i, dim in enumerate(layer_dims):
            setattr(self, f"dense_{i}", Dense(in_dim, dim))
            in_dim = dim

    def forward(self, x: torch.Tensor, *, deterministic: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"dense_{i}")(x))
            if not deterministic:
                x = dropout(x, self.dropout_rate, generator, data_shard(self))
        return x


class Highway(nn.Module):
    """H(x) * T(x) + x * (1 - T(x))."""

    def __init__(self, features: int):
        super().__init__()
        self.h = Dense(features, features)
        self.t = Dense(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.h(x))
        t = sigmoid(self.t(x))
        return h * t + x * (1.0 - t)


class MatmulConv1D(nn.Module):
    """SAME 1-D conv as one product of the k-shifted input with the
    flattened (k, in, out) kernel; pads (k-1)//2 left and k//2 right."""

    def __init__(self, in_dim: int, features: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_dim, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        t = x.shape[1]
        dt = compute_dtype(self)
        xp = F.pad(x, (0, 0, (k - 1) // 2, k // 2))
        x_cat = torch.cat([xp[:, j: j + t] for j in range(k)], dim=-1).to(dt)
        return x_cat @ self.kernel.reshape(-1, self.kernel.shape[-1]).to(dt)


def conv2d_stride2_same(x: torch.Tensor, kernel: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """3x3 stride-2 TF-SAME conv2d of NHWC ``x`` with a (3, 3, in, out)
    kernel, as 9 strided patch slices and one product in ``dtype``."""
    _, h, w, c = x.shape
    h_out, w_out = (h + 1) // 2, (w + 1) // 2
    pad_h = max(0, (h_out - 1) * 2 + 3 - h)
    pad_w = max(0, (w_out - 1) * 2 + 3 - w)
    xp = F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
    patches = [xp[:, di: di + 2 * h_out: 2, dj: dj + 2 * w_out: 2, :]
               for di in range(3) for dj in range(3)]
    w = kernel.reshape(9 * c, kernel.shape[-1]).to(dtype)
    return torch.cat(patches, dim=-1).to(dtype) @ w


class MatmulConv2DStride2(nn.Module):
    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, in_dim, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_stride2_same(x, self.kernel, compute_dtype(self))


def bank_tap_mask(bank_k: int, c_in: int, channels: int) -> np.ndarray:
    """0/1 mask over the (S*C_in, K*C_out) bank block matrix: block (shift s,
    bank k) is live iff 0 <= s + (k-1)//2 < k."""
    smin, smax = -((bank_k - 1) // 2), bank_k // 2
    nshift = smax - smin + 1
    mask = np.zeros((nshift, c_in, bank_k, channels), np.float32)
    for si, s in enumerate(range(smin, smax + 1)):
        for k in range(1, bank_k + 1):
            if 0 <= s + (k - 1) // 2 < k:
                mask[si, :, k - 1, :] = 1.0
    return mask.reshape(nshift * c_in, bank_k * channels)


class ConvBankBlock(nn.Module):
    """Conv1d bank of widths 1..K, each BN + ReLU, concatenated: one product
    of the shifted input with the masked block matrix ``bank_kernel``."""

    def __init__(self, c_in: int, bank_k: int, channels: int):
        super().__init__()
        self.bank_k = bank_k
        nshift = bank_k // 2 + (bank_k - 1) // 2 + 1
        self.bank_kernel = nn.Parameter(torch.empty(nshift * c_in, bank_k * channels))
        self.register_buffer("tap_mask", torch.from_numpy(
            bank_tap_mask(bank_k, c_in, channels)), persistent=False)
        self.bn = BatchNorm(bank_k * channels)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor],
                train: bool = False) -> torch.Tensor:
        x = mask_sequence(x, lengths)
        t = x.shape[1]
        smin, smax = -((self.bank_k - 1) // 2), self.bank_k // 2
        xp = F.pad(x, (0, 0, -smin, smax))
        dt = compute_dtype(self)
        x_cat = torch.cat([xp[:, s - smin: s - smin + t] for s in range(smin, smax + 1)],
                          dim=-1).to(dt)
        y = x_cat @ (self.bank_kernel * self.tap_mask).to(dt)
        return torch.relu(self.bn(y, train))


class CBHG(nn.Module):
    """Conv bank -> maxpool(2, stride 1) -> conv projections (+BN) ->
    residual -> highways -> BiGRU. Encoder body (K=16) and post-net (K=8).
    ``train`` takes the BatchNorms' batch statistics and the BiGRU's plain
    scans."""

    def __init__(self, in_dim: int, bank_k: int, bank_channels: int,
                 proj_channels: Sequence[int], highway_layers: int,
                 highway_dim: int, gru_dim: int):
        super().__init__()
        from .rnn import BiGRU

        self.num_proj = len(proj_channels)
        self.highway_layers = highway_layers
        self.bank = ConvBankBlock(in_dim, bank_k, bank_channels)
        c = bank_k * bank_channels
        for i, ch in enumerate(proj_channels):
            setattr(self, f"proj_{i}", MatmulConv1D(c, ch, 3))
            setattr(self, f"proj_bn_{i}", BatchNorm(ch))
            c = ch
        self.residual_proj = Dense(in_dim, c) if in_dim != c else None
        self.pre_highway = Dense(c, highway_dim) if c != highway_dim else None
        for i in range(highway_layers):
            setattr(self, f"highway_{i}", Highway(highway_dim))
        self.bigru = BiGRU(highway_dim, gru_dim)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                *, plain: bool = False, train: bool = False) -> torch.Tensor:
        residual = x
        y = self.bank(x, lengths, train)
        y = mask_sequence(y, lengths)
        padded = F.pad(y, (0, 0, 0, 1), value=-float("inf"))
        y = torch.maximum(padded[:, :-1], padded[:, 1:])
        for i in range(self.num_proj):
            y = mask_sequence(y, lengths)
            y = getattr(self, f"proj_bn_{i}")(getattr(self, f"proj_{i}")(y), train)
            if i + 1 < self.num_proj:
                y = torch.relu(y)
        if self.residual_proj is not None:
            residual = self.residual_proj(residual)
        y = y + residual
        if self.pre_highway is not None:
            y = self.pre_highway(y)
        for i in range(self.highway_layers):
            y = getattr(self, f"highway_{i}")(y)
        y = mask_sequence(y, lengths)
        out, _ = self.bigru(y, lengths, plain=plain, train=train)
        return out


class Conv1dBNStack(nn.Module):
    """Taco2 conv stack: N x (mask -> 1-D conv -> BatchNorm -> ReLU ->
    dropout). The padded positions are re-zeroed before each conv; ReLU
    follows every layer but the last unless ``final_activation``. Dropout
    runs only in training (``train=True``, drawn from ``generator``; a
    ``data_parallel`` shard draws the global batch's mask), unlike the
    prenets' it is off at inference."""

    def __init__(self, in_dim: int, channels: Sequence[int], kernel_size: int = 5,
                 dropout_rate: float = 0.5, final_activation: bool = True):
        super().__init__()
        self.num_layers = len(channels)
        self.dropout_rate = dropout_rate
        self.final_activation = final_activation
        for i, ch in enumerate(channels):
            setattr(self, f"conv_{i}", MatmulConv1D(in_dim, ch, kernel_size))
            setattr(self, f"bn_{i}", BatchNorm(ch))
            in_dim = ch

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor], *,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        for i in range(self.num_layers):
            x = mask_sequence(x, lengths)
            x = getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x), train)
            if i + 1 < self.num_layers or self.final_activation:
                x = torch.relu(x)
            if train and self.dropout_rate > 0.0:
                x = dropout(x, self.dropout_rate, generator, data_shard(self))
        return x
