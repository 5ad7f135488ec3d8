"""Keras-v2 GRU cell, masked GRU scan, BiGRU and the zoneout cell
(counterparts of ``gst_tacotron_tpu/models/rnn.py``), and Tacotron 2's LSTM
cell and BiLSTM, which have no JAX counterpart.

Layout as in the JAX package: ``kernel`` (in, 3H) and ``recurrent_kernel``
(H, 3H) with gate order z, r, n, separate ``bias`` and ``recurrent_bias``,
reset_after. ``GRU`` runs its whole sequence through ``ops.gru.gru_scan``,
``BiGRU`` both directions through ``ops.gru.bigru_scan`` (one launch): the
CUDA kernel (K1) on the card, its plain version on the CPU. ``plain=True``
picks the plain version on any device.

``train=True`` runs the plain masked scans on every device. That is the JAX
package's own choice (its GRU takes the Pallas kernel only when not
training), not a fallback: the kernel has no backward, and the plain scan is
autograd over torch ops.

The compute dtype (``modules.compute_dtype``) splits the two routes as the
JAX GRU splits them (``gst_tacotron_tpu/models/rnn.py:104-145``): the kernel
route (inference on the card) is float32 whatever the dtype, with casts at
its entry and exit; the scan (training, ``plain``, and inference on the CPU,
where JAX's GRU takes its scan too) runs in the compute dtype. In float32
the two are the same function.

``LSTMCell``, ``LSTM`` and ``BiLSTM`` keep the GRUs' layout with four gates,
i, f, g, o (``ops/lstm.py``). At inference on the card ``LSTM`` runs the
library's fused LSTM (float32, TF32 off); in training, with ``plain`` and on
the CPU its plain masked scan.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.gru import bigru_scan, gru_scan, gru_scan_plain, gru_update
from ..ops.lstm import lstm_scan, lstm_update
from .modules import compute_dtype


class _GRUParams(nn.Module):
    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.features = features
        self.kernel = nn.Parameter(torch.empty(in_dim, 3 * features))
        self.recurrent_kernel = nn.Parameter(torch.empty(features, 3 * features))
        self.bias = nn.Parameter(torch.empty(3 * features))
        self.recurrent_bias = nn.Parameter(torch.empty(3 * features))


class GRUCell(_GRUParams):
    """One Keras-v2 GRU step: (h, x) -> (h', h')."""

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = compute_dtype(self)
        x, h = x.to(dt), h.to(dt)
        h_new = gru_update(x @ self.kernel.to(dt) + self.bias.to(dt),
                           h @ self.recurrent_kernel.to(dt) + self.recurrent_bias.to(dt), h)
        return h_new, h_new


def kernel_route(xs: torch.Tensor, plain: bool, train: bool) -> bool:
    """Whether a GRU at inference takes K1: on the card unless ``plain`` or
    ``train`` (the JAX GRU's gate: its kernel unless training or on the
    CPU)."""
    return not (plain or train) and xs.device.type != "cpu"


class GRU(_GRUParams):
    """Unidirectional masked GRU over (B, T, D) -> ((B, T, H), final (B, H)).
    A step at or past a row's length holds the state."""

    def __init__(self, in_dim: int, features: int, reverse: bool = False):
        super().__init__(in_dim, features)
        self.reverse = reverse

    def forward(self, xs: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                initial_state: Optional[torch.Tensor] = None, *,
                plain: bool = False, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = compute_dtype(self)
        h0 = initial_state
        if h0 is None:
            h0 = xs.new_zeros(xs.shape[0], self.features, dtype=dt)
        if not kernel_route(xs, plain, train):
            return gru_scan_plain(xs.to(dt), h0.to(dt), self.kernel.to(dt), self.bias.to(dt),
                                  self.recurrent_kernel.to(dt), self.recurrent_bias.to(dt),
                                  lengths=lengths, reverse=self.reverse)
        f32 = torch.float32
        ys, final = gru_scan(xs.to(f32), h0.to(f32), self.kernel, self.bias,
                             self.recurrent_kernel, self.recurrent_bias, lengths=lengths,
                             reverse=self.reverse)
        return ys.to(dt), final.to(dt)


class BiGRU(nn.Module):
    """Bidirectional GRU; output concat -> (B, T, 2H). The flax submodules
    ``forward``/``backward`` are ``fwd``/``bwd`` here (``forward`` is the
    ``nn.Module`` method); ``weights.py`` maps the names."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.fwd = GRU(in_dim, features, reverse=False)
        self.bwd = GRU(in_dim, features, reverse=True)

    def forward(self, xs: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                *, plain: bool = False, train: bool = False):
        if not kernel_route(xs, plain, train):
            f, f_final = self.fwd(xs, lengths, plain=True)
            b, b_final = self.bwd(xs, lengths, plain=True)
            return torch.cat([f, b], dim=-1), (f_final, b_final)
        dt = compute_dtype(self)
        h0 = xs.new_zeros(xs.shape[0], self.fwd.features, dtype=torch.float32)
        fwd, bwd = ((h0, g.kernel, g.bias, g.recurrent_kernel, g.recurrent_bias)
                    for g in (self.fwd, self.bwd))
        ys, (f_final, b_final) = bigru_scan(xs.to(torch.float32), fwd, bwd, lengths=lengths)
        return ys.to(dt), (f_final.to(dt), b_final.to(dt))


class ZoneoutGRUCell(nn.Module):
    """GRU cell with zoneout on the state. Deterministic: h' = z * h + (1 -
    z) * h_new; otherwise each unit keeps its old h where a Bernoulli(z)
    draw from ``generator`` (never the global stream) is true. Returns
    (h', h'). The inner cell keeps flax's auto name ``GRUCell_0``."""

    def __init__(self, in_dim: int, features: int, zoneout: float = 0.1):
        super().__init__()
        self.zoneout = zoneout
        self.GRUCell_0 = GRUCell(in_dim, features)

    def forward(self, h: torch.Tensor, x: torch.Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h_new, _ = self.GRUCell_0(h, x)
        h = h.to(h_new.dtype)
        if self.zoneout > 0.0 and not deterministic:
            if generator is None:
                raise ValueError("the stochastic zoneout branch needs a torch.Generator")
            keep_old = torch.rand(h_new.shape, generator=generator,
                                  device=h_new.device) < self.zoneout
            h_new = torch.where(keep_old, h, h_new)
        elif self.zoneout > 0.0:
            h_new = self.zoneout * h + (1.0 - self.zoneout) * h_new
        return h_new, h_new


class _LSTMParams(nn.Module):
    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.features = features
        self.kernel = nn.Parameter(torch.empty(in_dim, 4 * features))
        self.recurrent_kernel = nn.Parameter(torch.empty(features, 4 * features))
        self.bias = nn.Parameter(torch.empty(4 * features))
        self.recurrent_bias = nn.Parameter(torch.empty(4 * features))


class LSTMCell(_LSTMParams):
    """One LSTM step, gate order i, f, g, o (``torch.nn.LSTMCell``'s):
    (x, (h, c)) -> (h', c')."""

    def forward(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h, c = state
        gates = x @ self.kernel + self.bias + h @ self.recurrent_kernel + self.recurrent_bias
        return lstm_update(gates, c)


class LSTM(_LSTMParams):
    """Unidirectional masked LSTM over (B, T, D) -> (B, T, H), zero initial
    state; a step at or past a row's length holds the state. Float32."""

    def __init__(self, in_dim: int, features: int, reverse: bool = False):
        super().__init__(in_dim, features)
        self.reverse = reverse

    def forward(self, xs: torch.Tensor, lengths: Optional[torch.Tensor] = None, *,
                plain: bool = False, train: bool = False) -> torch.Tensor:
        return lstm_scan(xs.float(), self.kernel, self.bias, self.recurrent_kernel,
                         self.recurrent_bias, lengths, self.reverse,
                         plain=not kernel_route(xs, plain, train))


class BiLSTM(nn.Module):
    """Bidirectional masked LSTM; output concat -> (B, T, 2H)."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.fwd = LSTM(in_dim, features, reverse=False)
        self.bwd = LSTM(in_dim, features, reverse=True)

    def forward(self, xs: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                *, plain: bool = False, train: bool = False):
        ys = [m(xs, lengths, plain=plain, train=train) for m in (self.fwd, self.bwd)]
        return torch.cat(ys, dim=-1).to(compute_dtype(self)), None
