"""Keras-v2 GRU cell, masked GRU scan and BiGRU (counterparts of
``gst_tacotron_tpu/models/rnn.py``).

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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.gru import bigru_scan, gru_scan, gru_scan_plain, gru_update


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
        h_new = gru_update(x @ self.kernel + self.bias,
                           h @ self.recurrent_kernel + self.recurrent_bias, h)
        return h_new, h_new


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
        h0 = initial_state
        if h0 is None:
            h0 = xs.new_zeros(xs.shape[0], self.features)
        scan = gru_scan_plain if plain or train else gru_scan
        return scan(xs, h0, self.kernel, self.bias, self.recurrent_kernel,
                    self.recurrent_bias, lengths=lengths, reverse=self.reverse)


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
        if plain or train:
            f, f_final = self.fwd(xs, lengths, plain=True)
            b, b_final = self.bwd(xs, lengths, plain=True)
            return torch.cat([f, b], dim=-1), (f_final, b_final)
        h0 = xs.new_zeros(xs.shape[0], self.fwd.features)
        fwd, bwd = ((h0, g.kernel, g.bias, g.recurrent_kernel, g.recurrent_bias)
                    for g in (self.fwd, self.bwd))
        return bigru_scan(xs, fwd, bwd, lengths=lengths)
