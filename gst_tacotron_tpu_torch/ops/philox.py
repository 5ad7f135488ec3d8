"""Philox4x32-10, the counter-based generator of ``csrc/common.cuh``, for the
kernels' plain versions.

``philox4x32_10`` takes numpy ``uint64`` arrays or torch ``int64`` tensors
holding 32-bit values and returns the four 32-bit outputs in the same type.
Its 32 x 32-bit products go through 16-bit limbs, so no intermediate exceeds
2^49 and signed 64-bit tensors (all that torch has on the card) give the same
bits as the kernels' unsigned arithmetic. ``uniform_open01`` maps 32 random
bits strictly inside (0, 1) as the kernels do.

Streams in use, told apart by the third counter word: 0 and 1 are the decode
kernel's prenet layers (``ops/decode.py``), 2 the WaveRNN sampler's Gumbel
noise (``ops/wavernn.py``).
"""

from __future__ import annotations

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF

STREAM_PRENET_0, STREAM_PRENET_1, STREAM_GUMBEL = 0, 1, 2


def _mulhilo(m: int, c):
    """(hi, lo) 32-bit halves of the 64-bit product m * c (m a 32-bit
    constant, c an array of 32-bit values)."""
    a = m * (c & 0xFFFF)                      # < 2^48
    b = m * (c >> 16)                         # < 2^48
    mid = a + ((b & 0xFFFF) << 16)            # < 2^49
    return (b >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c, key):
    """Ten Philox rounds of the counter ``c`` (four arrays) under ``key``
    (two Python ints); returns four arrays of 32-bit values."""
    c0, c1, c2, c3 = c
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def seed_key(seed: int):
    """The kernels' Philox key: the seed's low and high 32 bits."""
    return seed & _MASK32, (seed >> 32) & _MASK32


def uniform_open01(bits):
    """Top 23 of 32 random bits plus one half, times 2^-23: strictly inside
    (0, 1), every value exact in float32 (24 bits would round the top one up
    to 1.0). Returns float32 (numpy or torch, as given)."""
    top = bits >> 9
    if isinstance(top, torch.Tensor):
        return (top.to(torch.float32) + 0.5) * (1.0 / 8388608.0)
    return (top.astype(np.float32) + np.float32(0.5)) * np.float32(1.0 / 8388608.0)


def stream_uniforms(seed: int, steps, stream: int, batch: int, n: int, row0: int = 0):
    """(len(steps), batch, n) float32 uniforms: the kernels' draw for item
    ``i`` of row ``b`` at step ``s`` of ``stream``, counted by (i >> 2, s,
    stream, row0 + b) and taking output word i & 3. ``row0`` is the first
    row's index in the global batch (a data-parallel rank's shard draws the
    rows the whole batch would). ``steps`` is a numpy array or a torch tensor
    of step indices; the result is of the same kind, on the same device."""
    quads = (n + 3) // 4
    if isinstance(steps, torch.Tensor):
        dev = steps.device
        shape = (steps.shape[0], batch, quads)
        ctr = (torch.arange(quads, device=dev)[None, None, :].expand(shape),
               steps.to(torch.int64)[:, None, None].expand(shape),
               torch.full(shape, stream, dtype=torch.int64, device=dev),
               torch.arange(row0, row0 + batch, device=dev)[None, :, None].expand(shape))
        words = torch.stack(philox4x32_10(ctr, seed_key(seed)), dim=-1)
    else:
        shape = (len(steps), batch, quads)
        ctr = (np.broadcast_to(np.arange(quads, dtype=np.uint64)[None, None, :], shape),
               np.broadcast_to(np.asarray(steps, np.uint64)[:, None, None], shape),
               np.full(shape, stream, np.uint64),
               np.broadcast_to(np.arange(row0, row0 + batch, dtype=np.uint64)[None, :, None],
                               shape))
        words = np.stack(philox4x32_10(ctr, seed_key(seed)), axis=-1)
    return uniform_open01(words.reshape(shape[0], batch, 4 * quads)[..., :n])
