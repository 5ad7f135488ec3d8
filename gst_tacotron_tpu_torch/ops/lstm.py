"""The LSTM cell and the masked LSTM scan of Tacotron 2's encoder.

Layout as the port's GRUs keep theirs: ``kernel`` (in, 4H) and
``recurrent_kernel`` (H, 4H), with separate ``bias`` and ``recurrent_bias``,
gate order i, f, g, o (``torch.nn.LSTMCell``'s: its ``weight_ih`` is
``kernel.T``, ``weight_hh`` is ``recurrent_kernel.T``, ``bias_ih`` is ``bias``
and ``bias_hh`` is ``recurrent_bias``). One step:

    c' = sigmoid(f) * c + sigmoid(i) * tanh(g),  h' = sigmoid(o) * tanh(c')

``lstm_scan`` runs a (B, T, D) sequence in either direction with lengths, a
step at or past a row's length holding the state, as the masked GRU scans
do: on the card the library's fused LSTM (cuDNN, float32, TF32 off) on the
sequence (forward) or on each row's valid steps reversed in place (reverse,
so the scan starts at the row's last valid step, as a packed sequence
would); on the CPU, or with ``plain``, ``lstm_scan_plain``. Both give the
same outputs at the valid steps.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def lstm_update(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h', c') from the summed pre-activations (..., 4H) in gate order i,
    f, g, o and the cell state c (..., H)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _valid(xs: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    b, t = xs.shape[:2]
    if lengths is None:
        return torch.ones(b, t, dtype=torch.bool, device=xs.device)
    return torch.arange(t, device=xs.device)[None, :] < lengths.to(xs.device)[:, None]


def lstm_scan_plain(xs: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor, wh: torch.Tensor,
                    bh: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                    reverse: bool = False) -> torch.Tensor:
    """The masked scan step by step in torch ops -> ys (B, T, H). Autograd
    runs through it."""
    b, t, _ = xs.shape
    h_dim = wh.shape[0]
    gx = xs @ wi + bi
    h = xs.new_zeros(b, h_dim)
    c = xs.new_zeros(b, h_dim)
    valid = _valid(xs, lengths)
    ys = [None] * t
    for i in (range(t - 1, -1, -1) if reverse else range(t)):
        hn, cn = lstm_update(gx[:, i] + h @ wh + bh, c)
        keep = valid[:, i, None]
        h, c = torch.where(keep, hn, h), torch.where(keep, cn, c)
        ys[i] = h
    return torch.stack(ys, 1)


def _row_reversal(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B, T) indices that reverse each row's first ``lengths`` steps in
    place and leave the rest: an involution."""
    pos = torch.arange(t, device=lengths.device)[None, :]
    n = lengths.to(torch.int64)[:, None]
    return torch.where(pos < n, n - 1 - pos, pos)


def _gather_steps(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def lstm_scan(xs: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor, wh: torch.Tensor,
              bh: torch.Tensor, lengths: Optional[torch.Tensor] = None, reverse: bool = False,
              plain: bool = False) -> torch.Tensor:
    """The masked LSTM scan of ``xs`` (B, T, D) -> ys (B, T, H): the
    library's fused LSTM on the card, ``lstm_scan_plain`` on the CPU or with
    ``plain``. Outputs at or past a row's length are the held state on the
    plain route and unspecified on the library's: callers mask them."""
    if plain or xs.device.type == "cpu":
        return lstm_scan_plain(xs, wi, bi, wh, bh, lengths, reverse)
    b, t, _ = xs.shape
    if lengths is None:
        lengths = torch.full((b,), t, device=xs.device)
    idx = _row_reversal(lengths, t) if reverse else None
    x = _gather_steps(xs, idx) if reverse else xs
    h_dim = wh.shape[0]
    h0 = xs.new_zeros(1, b, h_dim)
    # the four operands as views of one buffer in cuDNN's order, so the
    # library takes them without compacting them again
    buf = torch.cat([wi.t().reshape(-1), wh.t().reshape(-1), bi, bh])
    shapes = ((4 * h_dim, wi.shape[0]), (4 * h_dim, h_dim), (4 * h_dim,), (4 * h_dim,))
    flat = [v.view(shape) for v, shape in
            zip(buf.split([math.prod(sh) for sh in shapes]), shapes)]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        ys, _, _ = torch.lstm(x.contiguous(), (h0, h0), flat, True, 1, 0.0, False, False,
                              True)
    return _gather_steps(ys, idx) if reverse else ys
