"""Philox4x32-10 and the dropout and Gumbel streams drawn from it (a frozen
copy of the generator the port's decoder and WaveRNN sampler use).

A draw for item ``i`` of row ``b`` at step ``s`` of stream ``k`` is output
word ``i & 3`` of the counter (i >> 2, s, k, row0 + b) under the key (seed's
low 32 bits, its high 32 bits), mapped to (top 23 bits + 0.5) / 2^23. The 32 x
32-bit products go through 16-bit limbs, so signed 64-bit tensors give the
unsigned bits.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF

STREAM_PRENET_0, STREAM_PRENET_1, STREAM_GUMBEL = 0, 1, 2


def _mulhilo(m: int, c: torch.Tensor):
    a = m * (c & 0xFFFF)
    b = m * (c >> 16)
    mid = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c, seed: int):
    c0, c1, c2, c3 = c
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def uniforms(seed: int, steps: torch.Tensor, stream: int, batch: int, n: int,
             row0: int = 0) -> torch.Tensor:
    """(len(steps), batch, n) float32 uniforms strictly inside (0, 1)."""
    dev = steps.device
    quads = (n + 3) // 4
    shape = (steps.shape[0], batch, quads)
    ctr = (torch.arange(quads, device=dev)[None, None, :].expand(shape),
           steps.to(torch.int64)[:, None, None].expand(shape),
           torch.full(shape, stream, dtype=torch.int64, device=dev),
           torch.arange(row0, row0 + batch, device=dev)[None, :, None].expand(shape))
    words = torch.stack(philox4x32_10(ctr, seed & 0xFFFFFFFFFFFFFFFF), dim=-1)
    top = words.reshape(shape[0], batch, 4 * quads)[..., :n] >> 9
    return (top.to(torch.float32) + 0.5) * (1.0 / 8388608.0)
