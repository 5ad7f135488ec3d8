"""K5: WaveRNN autoregressive mu-law sampling (counterpart of
``ops/wavernn_pallas.py``).

``wavernn_sample`` launches ``csrc/wavernn_sample.cu`` for CUDA tensors and
runs ``wavernn_sample_plain`` for CPU tensors. Both take the packed weights
of ``pack_wavernn_weights`` and the FRAME-rate conditioning ``cond`` (B, T, C)
(``cond_proj`` of the mel; sample s reads frame s // hop, so the repeat to
sample rate is never materialized) and return mu-law classes (B, T*hop)
int32. ``greedy`` takes the argmax; otherwise Gumbel-max over
``logits / temperature`` with noise from the Philox stream
``gumbel_uniforms``, which the kernel draws too. That stream is not
jax.random's: sampled classes match the JAX package in distribution only.

The kernel hoists the input product out of its loop (``input_tables``:
embed @ wi + bi and cond @ wi once a call, a row of each a sample); the
plain version keeps the JAX kernel's un-hoisted step and is the oracle.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .build import (F, I, P, U64, CudaKernel, check_cuda, ptr, refuse_grad, sm_count,
                    stream_ptr)
from .gru import gru_scan_plain, gru_update
from .philox import STREAM_GUMBEL, stream_uniforms

KERNEL = CudaKernel("wavernn_sample.cu", "wavernn_sample_launch",
                    [P, P, P, P, P, P, P, P, P, I, I, I, I, U64, F, I, P])
# rows a launch and the prologue GEMM's tile (the kernel's WR_ROWS and
# WR_GEMM_TILE)
LAUNCH_ROWS, GEMM_TILE = 32, 64
_MAX_SMEM = 232448

# order of the kernel's WaveWeights struct
_WEIGHT_ORDER = ("embed", "wi", "bi", "wh", "bh", "fc1", "fb1", "fc2", "fb2")
# samples of Gumbel noise the plain version draws at once, and of scores
# the teacher-forced hold compares at once
_NOISE_CHUNK = 256
_GAP_CHUNK = 4096


def pack_wavernn_weights(model, *, differentiable: bool = False) -> Dict[str, torch.Tensor]:
    """The kernel's operands from a ``models.wavernn.WaveRNN`` (the arrays of
    the JAX ``pack_wavernn_weights``). ``cond_proj`` stays outside: the
    sampler takes conditioning already projected. With ``differentiable``
    the operands are the parameters themselves (the teacher-forced pass
    trains through them); otherwise detached, contiguous copies."""
    packed = dict(embed=model.sample_embed.embedding,
                  wi=model.gru.kernel, bi=model.gru.bias,
                  wh=model.gru.recurrent_kernel, bh=model.gru.recurrent_bias,
                  fc1=model.fc1.kernel, fb1=model.fc1.bias,
                  fc2=model.fc2.kernel, fb2=model.fc2.bias)
    if differentiable:
        return packed
    return {k: v.detach().to(torch.float32).contiguous() for k, v in packed.items()}


def input_tables(packed: Dict[str, torch.Tensor], cond: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's hoisted input product, in plain PyTorch: (embed @ wi + bi
    (K, 3H), cond @ wi (B, T, 3H)). Sample s of row b then takes
    ``table[prev] + cond_table[b, s // hop]`` where the un-hoisted step takes
    ``(embed[prev] + cond[b, s // hop]) @ wi + bi``: the same sum, rounded
    in another order."""
    w = packed
    return w["embed"] @ w["wi"] + w["bi"], cond @ w["wi"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def sample_smem(c: int, h: int, f: int, k: int, grid: int) -> int:
    """Shared memory of a K5 CTA on ``grid`` CTAs (mirrors
    ``csrc/wavernn_sample.cu::wave_smem_floats``): the state and ReLU(fc1) of
    32 rows (rows of H and F rounded up to 128, plus 4), the CTA's slices of
    wh, fc1 and fc2, of embed @ wi + bi, of this frame's cond @ wi and of
    the recurrent gates, the scores, the biases and the classes, in bytes."""
    nu, nf, nk = -(-h // grid), -(-f // grid), 4 * -(-k // (4 * grid))
    hs, fs = _round_up(h, 128) + 4, _round_up(f, 128) + 4
    na, nf4 = _round_up(3 * nu, 4), _round_up(nf, 4)
    floats = (LAUNCH_ROWS * (hs + fs) + na * hs + nf4 * hs + nk * fs + k * na
              + 2 * LAUNCH_ROWS * na + LAUNCH_ROWS * nk + na + nf4 + nk + LAUNCH_ROWS)
    return 4 * max(floats, 16 * (2 * GEMM_TILE + 4))


def gumbel_uniforms(seed: int, steps, batch: int, num_classes: int, row0: int = 0):
    """(len(steps), batch, num_classes) float32 uniforms strictly inside
    (0, 1): the kernel's draw for (sample, row, class), the rows counted from
    ``row0``. ``steps`` is a numpy array (the numpy twin) or a torch tensor
    of sample indices."""
    return stream_uniforms(seed, steps, STREAM_GUMBEL, batch, num_classes, row0)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u))


def wavernn_sample_plain(packed: Dict[str, torch.Tensor], cond: torch.Tensor, *,
                         hop: int, seed: int = 0, temperature: float = 1.0,
                         greedy: bool = False, row0: int = 0) -> torch.Tensor:
    """The same sampler in plain PyTorch, one sample per loop iteration."""
    w = packed
    b, t, _ = cond.shape
    n = t * hop
    dev = cond.device
    k = w["embed"].shape[0]
    h = cond.new_zeros(b, w["wh"].shape[0])
    prev = torch.full((b,), k // 2, dtype=torch.int64, device=dev)
    out = []
    noise = None
    for s in range(n):
        if not greedy and s % _NOISE_CHUNK == 0:
            steps = torch.arange(s, min(n, s + _NOISE_CHUNK), device=dev)
            noise = gumbel(gumbel_uniforms(seed, steps, b, k, row0))
        x = w["embed"][prev] + cond[:, s // hop]
        h = gru_update(x @ w["wi"] + w["bi"], h @ w["wh"] + w["bh"], h)
        logits = torch.relu(h @ w["fc1"] + w["fb1"]) @ w["fc2"] + w["fb2"]
        scores = logits if greedy else logits / temperature + noise[s % _NOISE_CHUNK]
        prev = torch.argmax(scores, dim=-1)
        out.append(prev)
    if not out:
        return torch.empty(b, 0, dtype=torch.int32, device=dev)
    return torch.stack(out, 1).to(torch.int32)


def teacher_forced_logits(packed: Dict[str, torch.Tensor], cond: torch.Tensor,
                          classes: torch.Tensor, *, hop: int) -> torch.Tensor:
    """Logits (B, T*hop, K) of every sample given the classes before it
    (B, T*hop): the teacher-forced pass of the WaveRNN, in plain PyTorch."""
    w = packed
    b = cond.shape[0]
    k = w["embed"].shape[0]
    start = torch.full((b, 1), k // 2, dtype=torch.int64, device=cond.device)
    prev = torch.cat([start, classes[:, :-1].to(torch.int64)], 1)
    x = w["embed"][prev] + torch.repeat_interleave(cond, hop, dim=1)
    h0 = cond.new_zeros(b, w["wh"].shape[0])
    ys, _ = gru_scan_plain(x, h0, w["wi"], w["bi"], w["wh"], w["bh"])
    return torch.relu(ys @ w["fc1"] + w["fb1"]) @ w["fc2"] + w["fb2"]


def score_gaps(packed: Dict[str, torch.Tensor], cond: torch.Tensor,
               classes: torch.Tensor, *, hop: int, seed: int = 0,
               temperature: float = 1.0, greedy: bool = False, row0: int = 0
               ) -> torch.Tensor:
    """(B, T*hop): how far each sampled class scores below the best class of
    its step, with the plain teacher-forced pass run on those same classes
    (0 where the class is the plain argmax). This holds a sampler whose sums
    run in another order: a near-tie may flip, after which the two samplers'
    histories part, but every class must stay within rounding of the best."""
    logits = teacher_forced_logits(packed, cond, classes, hop=hop)
    b, n, k = logits.shape
    gaps = []
    for s0 in range(0, n, _GAP_CHUNK):
        sc = logits[:, s0: s0 + _GAP_CHUNK]
        if not greedy:
            steps = torch.arange(s0, s0 + sc.shape[1], device=cond.device)
            noise = gumbel(gumbel_uniforms(seed, steps, b, k, row0)).transpose(0, 1)
            sc = sc / temperature + noise
        chosen = sc.gather(-1, classes[:, s0: s0 + sc.shape[1], None].to(torch.int64))
        gaps.append(sc.max(-1).values - chosen[..., 0])
    return torch.cat(gaps, 1)


def wavernn_sample(packed: Dict[str, torch.Tensor], cond: torch.Tensor, *,
                   hop: int, seed: int = 0, temperature: float = 1.0,
                   greedy: bool = False, row0: int = 0) -> torch.Tensor:
    """WaveRNN sampling: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Row ``b``'s Gumbel noise is row ``row0 + b``'s of a
    global batch (a data-parallel shard samples the rows the whole batch
    would)."""
    if cond.device.type == "cpu":
        return wavernn_sample_plain(packed, cond, hop=hop, seed=seed,
                                    temperature=temperature, greedy=greedy, row0=row0)
    refuse_grad("wavernn_sample", cond, *packed.values())
    w = packed
    b, t, c = cond.shape
    k, hdim, f = w["embed"].shape[0], w["wh"].shape[0], w["fc1"].shape[1]
    shapes = dict(embed=(k, c), wi=(c, 3 * hdim), bi=(3 * hdim,), wh=(hdim, 3 * hdim),
                  bh=(3 * hdim,), fc1=(hdim, f), fb1=(f,), fc2=(f, k), fb2=(k,))
    for name, shape in shapes.items():
        if tuple(w[name].shape) != shape:
            raise ValueError(f"wavernn_sample: {name} has shape {tuple(w[name].shape)}, "
                             f"expected {shape}")
    if hop < 1 or row0 < 0 or (not greedy and not temperature > 0):
        raise ValueError(f"wavernn_sample: hop={hop}, row0={row0}, "
                         f"temperature={temperature}")
    cond = cond.contiguous()
    ws = [w[name] for name in _WEIGHT_ORDER]
    check_cuda("wavernn_sample", cond, *ws)
    classes = torch.empty(b, t * hop, dtype=torch.int32, device=cond.device)
    if b == 0 or t == 0:
        return classes
    grid = sm_count(cond.device.index)
    smem = sample_smem(c, hdim, f, k, grid)
    if smem > _MAX_SMEM:
        raise ValueError(f"wavernn_sample: C={c}, H={hdim}, F={f}, K={k} need {smem} bytes "
                         "of shared memory a CTA, more than one block has")
    dev = cond.device
    dims = (ctypes.c_int * 6)(t, hop, c, hdim, f, k)
    wptrs = (ctypes.c_void_p * len(ws))(*[x.data_ptr() for x in ws])
    for b0 in range(0, b, LAUNCH_ROWS):
        rows = min(LAUNCH_ROWS, b - b0)
        table = torch.empty(k + rows * t, 3 * hdim, device=dev, dtype=torch.float32)
        hg = torch.zeros(rows, _round_up(hdim, 4), device=dev, dtype=torch.float32)
        fg = torch.zeros(rows, _round_up(f, 4), device=dev, dtype=torch.float32)
        keys = torch.zeros(3, LAUNCH_ROWS, device=dev, dtype=torch.int64)
        count = torch.zeros(1, device=dev, dtype=torch.int32)
        KERNEL(ptr(cond[b0:]), wptrs, dims, ptr(table), ptr(hg), ptr(fg), ptr(keys), ptr(count),
               ptr(classes[b0:]), rows, row0 + b0, t * hop, grid, seed & 0xFFFFFFFFFFFFFFFF,
               float(temperature), int(greedy), stream_ptr(dev))
    return classes

