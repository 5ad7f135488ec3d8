"""The three mel-STFT kernels (counterparts of ``gst_tacotron_tpu/ops/stft_pallas.py``).

All three compute normalized-dB mel and linear features of the window's
live taps, through the mixed-radix FFT of ``csrc/fft.cuh`` (plan and table
from ``fft_plan``; any hop | n_fft, each transform in shared memory or, past
``MAX_FFT_SIZE``, in a device-memory scratch) and a sparse mel over each
filter's nonzero bins, in one launch:

  K3   ``stft_features``        <- ``stft_features_pallas_resident``:
       (B, L) wav (``csrc/stft_features.cu``); ``bf16`` is the resident
       kernel's bf16 operand mode (frames and bases, then magnitudes and the
       mel basis, rounded to bfloat16, float32 sums), on the tensor-core
       kernel of ``csrc/stft_bf16.cuh`` (wgmma on TMA-fed bases) with a
       bf16 mel;
  K3′  ``stft_features_fused``  <- ``stft_features_pallas_fused``: the same
       function through the same kernel (``csrc/stft_wav.cuh``), with its own
       launcher and counter; ``bf16_bases`` runs the window-baked DFT
       products on the same tensor-core kernel as K3's ``bf16`` with a
       float32 mel (``csrc/stft_fused.cu``);
  K3″  ``stft_features_frames`` <- ``stft_features_pallas``: (F, n_fft) raw
       frames -> (F, M), (F, NF) (``csrc/stft_frames.cu``).

The wav input is preemphasized and reflect-padded at the centre per
utterance, zero-padded to a bucket length; outputs are (mel (B, T, M),
linear (B, T, NF)) with T = 1 + (L - n_fft) // hop. ``normalize_linear=False``
returns the linear magnitude instead of its normalized dB (the mel is always
normalized). Each wrapper launches its kernel for CUDA tensors and runs its
plain version (``stft_features_plain`` for K3 and K3′,
``stft_features_frames_plain`` for K3″) for CPU tensors. ``KernelDSP`` is the
``PallasDSP`` counterpart: preemphasis, framing, then K3″.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import AudioConfig
from ..device import resolve_device
from ..dsp.mel import mel_filterbank
from ..dsp.ref import live_tap_span, padded_window
from ..dsp.torch_dsp import TorchDSP
from .build import F, I, P, CudaKernel, check_cuda, ptr, refuse_grad, sm_count, stream_ptr

# K3 and K3′ share one launcher signature (csrc/stft_features.cu,
# csrc/stft_fused.cu)
_WAV_ARGS = [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P, I,
             F, F, F, I, I, I, P, P]
KERNEL = CudaKernel("stft_features.cu", "stft_features_launch", _WAV_ARGS, branches=("bf16",))
FUSED_KERNEL = CudaKernel("stft_fused.cu", "stft_fused_launch", _WAV_ARGS)
FRAMES_KERNEL = CudaKernel("stft_frames.cu", "stft_frames_launch",
                           [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, I, F, F, F, I, I,
                            P, P])
# the plain bases' and the mel basis's bin padding
FREQ_TILE = 128

Features = Tuple[torch.Tensor, torch.Tensor]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=4)
def _mel_t_np(cfg: AudioConfig) -> np.ndarray:
    """The transposed mel basis (NFp, M); bins past num_freq are zero."""
    mel = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.mel_fmin,
                         cfg.mel_fmax)
    mel_t = np.zeros((_round_up(cfg.num_freq, FREQ_TILE), cfg.num_mels), np.float32)
    mel_t[:cfg.num_freq] = mel.T
    return mel_t


@functools.lru_cache(maxsize=4)
def _bases_np(cfg: AudioConfig):
    """Window-baked DFT cos/sin bases over the live taps (n_live, NFp) and the
    transposed mel basis (NFp, M); bins past num_freq are zero. The dense
    bases are the plain versions' and the bf16 mode's (n_live * NFp floats
    each): the FFT kernels never build them."""
    n_fft, n_freq = cfg.n_fft, cfg.num_freq
    n_freq_pad = _round_up(n_freq, FREQ_TILE)
    j0, j1, _ = live_tap_span(cfg)
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freq_pad)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    win = padded_window(cfg.win_length, n_fft)[:, None]
    cos_b = (np.cos(ang) * win).astype(np.float32)
    sin_b = (-np.sin(ang) * win).astype(np.float32)
    cos_b[:, n_freq:] = 0.0
    sin_b[:, n_freq:] = 0.0
    sl = slice(j0 * cfg.hop_length, j1 * cfg.hop_length)
    return (np.ascontiguousarray(cos_b[sl]), np.ascontiguousarray(sin_b[sl]),
            _mel_t_np(cfg))


def fft_radices(n: int) -> Tuple[int, ...]:
    """The stage radices of the mixed-radix FFT of length n, in the order the
    kernels run them: 4 while it divides, one 2, then 3s, 5s, and the other
    (odd prime) factors ascending, each a direct DFT (the generic stage)."""
    if n < 1:
        raise ValueError(f"fft_radices: length {n} < 1")
    out = []
    for r in (4, 2, 3, 5):
        while n % r == 0:
            out.append(r)
            n //= r
    f = 7
    while n > 1:
        if f * f > n:
            out.append(n)
            break
        while n % f == 0:
            out.append(f)
            n //= f
        f += 2
    return tuple(out)


def fft_plan(n_fft: int) -> Tuple[Tuple[int, ...], np.ndarray]:
    """The mixed-radix FFT of K3, K3′ and K3″ (``csrc/fft.cuh::fft_mixed``):
    (radices, table). An even n_fft packs the real frame into an
    n_fft/2-point complex transform and splits it; an odd one transforms the
    real frame as n_fft complex points. The table (complex128) holds, stage
    by stage, exp(-2 pi i k q / (R p)) for q = 1..R-1 (q-major), k < p
    (n - 1 entries in all), then each generic stage's roots
    exp(-2 pi i m / R), m < R, then, for an even n_fft, the split twiddles
    exp(-2 pi i k / n_fft), k = 0..n_fft/2."""
    n = n_fft // 2 if n_fft % 2 == 0 else n_fft
    radices = fft_radices(n)
    parts, roots, p = [], [], 1
    for r in radices:
        k = np.arange(p)
        parts += [np.exp(-2j * np.pi * k * q / (r * p)) for q in range(1, r)]
        if r > 5:
            roots.append(np.exp(-2j * np.pi * np.arange(r) / r))
        p *= r
    parts += roots
    if n_fft % 2 == 0:
        parts.append(np.exp(-2j * np.pi * np.arange(n + 1) / n_fft))
    return radices, np.concatenate(parts) if parts else np.zeros(0, np.complex128)


def sparse_mel(mel_t: np.ndarray, num_freq: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each mel filter's nonzero bins, from the dense (>= num_freq, M) basis:
    (lo (M,) its first nonzero bin, off (M + 1,) offsets into w, w the
    weights of bins lo .. last nonzero in ascending order, zeros between
    included). An all-zero filter has no weights."""
    dense = mel_t[:num_freq]
    lo, off, w = [], [0], []
    for m in range(dense.shape[1]):
        nz = np.flatnonzero(dense[:, m])
        first, last = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
        lo.append(first)
        w.append(dense[first:last, m])
        off.append(off[-1] + last - first)
    return (np.asarray(lo, np.int32), np.asarray(off, np.int32),
            np.concatenate(w).astype(np.float32))


@functools.lru_cache(maxsize=4)
def _fft_tables_np(cfg: AudioConfig):
    """The FFT kernels' tables: the float64 twiddles of ``fft_plan`` and the
    live window taps as float32, and the sparse mel of the float32 basis."""
    j0, j1, _ = live_tap_span(cfg)
    _, tw = fft_plan(cfg.n_fft)
    win = padded_window(cfg.win_length, cfg.n_fft)[j0 * cfg.hop_length: j1 * cfg.hop_length]
    lo, off, w = sparse_mel(_mel_t_np(cfg), cfg.num_freq)
    return {"fft_twiddle": np.stack([tw.real, tw.imag], -1).astype(np.float32),
            "fft_window": win.astype(np.float32),
            "mel_lo": lo, "mel_off": off, "mel_w": w}


def stft_bases(cfg: AudioConfig, device) -> Dict[str, torch.Tensor]:
    """The kernels' device tables: ``mel_t`` (the plain versions' mel), the
    FFT's ``fft_twiddle``, ``fft_window`` and the sparse mel ``mel_lo``,
    ``mel_off``, ``mel_w``."""
    tables = {"mel_t": _mel_t_np(cfg), **_fft_tables_np(cfg)}
    return {name: torch.from_numpy(a).to(device) for name, a in tables.items()}


@functools.lru_cache(maxsize=4)
def dft_bases(cfg: AudioConfig, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain versions' window-baked cos/sin bases (n_live, num_freq) on
    ``device``, built at their first call and kept."""
    cos_b, sin_b, _ = _bases_np(cfg)
    nf = cfg.num_freq
    return (torch.from_numpy(np.ascontiguousarray(cos_b[:, :nf])).to(device),
            torch.from_numpy(np.ascontiguousarray(sin_b[:, :nf])).to(device))


@functools.lru_cache(maxsize=4)
def _bf16_bases(cfg: AudioConfig, device: str) -> torch.Tensor:
    """The bf16 kernel's tables on ``device``, built at the first bf16 call
    and kept, as int32 (pairs of bf16): ``wgmma_bases`` of the window-baked
    cos/sin bases (the launcher's tensor map reads them as bf16), then, at
    the plan's ``mel_frag`` (in 8-byte units), each window's 144 rows of the
    mel basis rounded to bfloat16 as ``mma_b_layout`` fragments
    (windows, mel_nt, 9, 32, 2): the bf16 mel product's B operand."""
    plan = bf16_plan(cfg.n_fft, cfg.hop_length, live_tap_span(cfg)[2], cfg.num_mels)
    cos_b, sin_b = dft_bases(cfg, device)
    bases = wgmma_bases(cos_b, sin_b, plan["windows"], plan["kp"]).view(torch.int32).reshape(-1)
    nfw, nt = plan["windows"] * BF16_WINDOW, plan["mel_nt"]
    if nt == 0:                 # past 128 mels the kernel sums the filters instead
        return bases
    mel = torch.zeros(nfw, 8 * nt, dtype=torch.float32)
    mel_t = torch.from_numpy(_mel_t_np(cfg))[:nfw]
    mel[:mel_t.shape[0], :cfg.num_mels] = mel_t
    frags = [mma_b_layout(mel[w * BF16_WINDOW:(w + 1) * BF16_WINDOW]).reshape(-1)
             for w in range(plan["windows"])]
    return torch.cat([bases, *(f.to(bases.device) for f in frags)])


# a block's shared memory, and the FFT kernels' entries of stft_bases
_MAX_SMEM = 232448
_FFT_TABLES = ("fft_twiddle", "fft_window", "mel_lo", "mel_off", "mel_w")


def mixed_fft_smem(n_fft: int, frames: int) -> int:
    """Shared memory of a K3 / K3′ / K3″ block of ``frames`` frames: two
    ping-pong buffers of the complex transform (n_fft / 2 points for an even
    n_fft, n_fft for an odd one); the second first holds the frames' taps."""
    n = n_fft // 2 if n_fft % 2 == 0 else n_fft
    return 2 * 8 * frames * n


# the largest n_fft one frame of the FFT fits in shared memory: 29056 when
# even, 14527 when odd (a transform of 14528 points would fit); a larger one
# runs on a device-memory scratch
MAX_FFT_SIZE = {"even": _MAX_SMEM // 8, "odd": _MAX_SMEM // 16 - 1}


def fft_frames_per_block(n_fft: int, groups: int, frames: int, sms: int) -> int:
    """Frames a K3 / K3′ / K3″ block owns in shared memory: the most of 4,
    2, 1 whose buffers fit one block and whose grid (``groups`` x
    ceil(frames / fr) blocks) still gives each of ``sms`` SMs two blocks; 1
    when none does; 0 when even one frame does not fit (past
    ``MAX_FFT_SIZE``): the kernel then runs each frame's stages on a
    device-memory scratch, ``scratch_slots`` blocks a group."""
    if mixed_fft_smem(n_fft, 1) > _MAX_SMEM:
        return 0
    for fr in (4, 2):
        if mixed_fft_smem(n_fft, fr) <= _MAX_SMEM and groups * -(-frames // fr) >= 2 * sms:
            return fr
    return 1


def scratch_slots(groups: int, frames: int, sms: int) -> int:
    """Blocks a group (an utterance, or all the frames of K3″) when frames
    run on the device-memory scratch: two an SM over the grid, at most one a
    frame."""
    return max(1, min(frames, -(-2 * sms // max(groups, 1))))


def _fft_scratch(n_fft: int, groups: int, frames: int, fr: int, device):
    """(slots, scratch) of a launch: the device-memory buffers of the scratch
    mode (fr = 0, two transforms a block), else (0, None)."""
    if fr:
        return 0, None
    n = n_fft // 2 if n_fft % 2 == 0 else n_fft
    slots = scratch_slots(groups, frames, sm_count(device.index))
    return slots, torch.empty(groups * slots * 2 * n * 2, device=device, dtype=torch.float32)


@functools.lru_cache(maxsize=16)
def check_fft_size(cfg: AudioConfig) -> int:
    """Shared memory of a one-frame block of the FFT kernels (K3, K3′ float32,
    K3″) for ``cfg``, or 0 when the transform runs on a device-memory
    scratch instead (past ``MAX_FFT_SIZE``). Raises ValueError only on a
    config no STFT takes (hop must divide n_fft)."""
    if cfg.n_fft < 2 or cfg.hop_length < 1 or cfg.n_fft % cfg.hop_length:
        raise ValueError(f"STFT kernels: hop_length {cfg.hop_length} must divide "
                         f"n_fft {cfg.n_fft}")
    smem = mixed_fft_smem(cfg.n_fft, 1)
    return smem if smem <= _MAX_SMEM else 0


# the bf16 kernel's tiles (csrc/stft_bf16.cuh): 64 frames (wgmma m64), 144
# bins a window (two consumer warpgroups of wgmma n72), 64 taps a ring stage
# (a 128-byte swizzle row), 2 ring stages of cos and sin; two CTAs an SM
BF16_TILE, BF16_WINDOW, BF16_K, BF16_STAGES = 64, 144, 64, 2
BF16_MAX_CW = 8
_BF16_STAGE = 2 * BF16_WINDOW * BF16_K * 2
_SM_SMEM = 233472               # an SM's shared memory, 1 KB of it reserved a CTA
# the launcher's Bf16Plan, field by field
BF16_PLAN_FIELDS = ("windows", "cw", "kp", "span", "stride", "kch", "stages", "scratch",
                    "a_bytes", "smem", "mel_nt", "mel_frag")


def wgmma_bases(cos_b: torch.Tensor, sin_b: torch.Tensor, windows: int,
                kp: int) -> torch.Tensor:
    """The bf16 kernel's bases: the (n_live, nf) cos and sin bases rounded
    to bfloat16 (``round_bf16``'s rounding) and laid out K-major as its
    tensor map reads them, (2 * windows * 144, kp) bf16: row n is bin n's
    taps (cos rows, then sin rows from windows * 144), zero past the bins
    and the live taps."""
    n_live, nf = cos_b.shape
    nfw = windows * BF16_WINDOW
    out = torch.zeros(2 * nfw, kp, dtype=torch.bfloat16, device=cos_b.device)
    out[:nf, :n_live] = cos_b.t().to(torch.bfloat16)
    out[nfw:nfw + nf, :n_live] = sin_b.t().to(torch.bfloat16)
    return out


def bf16_plan(n_fft: int, hop: int, n_live: int, num_mels: int) -> Dict[str, int]:
    """The bf16 kernel's launch for (n_fft, hop, n_live, num_mels) (mirrors
    ``csrc/stft_bf16.cuh``): ``windows`` of 144 bins over the n_fft/2 + 1,
    clusters of ``cw`` CTAs (the next power of two of the windows, at most
    8; one window a CTA up to 8 windows, else several, with the magnitudes
    through a device-memory ``scratch``, as also past 142 mels, whose
    partial sums would not fit the ring), the taps padded to ``kp``, and
    the staged taps: the 64 frames' wav span (``span``, hop-long segments at
    ``stride`` = hop + pad, stride = 8 mod 64) where hop is even and it
    fits two CTAs an SM, else rows of ``kch`` taps a chunk at ``stride``
    kch + 8; ``smem`` the CTA's shared memory (ring, taps, barriers, 1 KB of
    alignment slack; the magnitude tile reuses the ring); ``mel_nt`` n8 tiles
    of the bf16 mode's tensor-core mel product (0 past 128 mels: the
    filters' sums instead) and ``mel_frag`` where its fragments start in
    the tables (8-byte units)."""
    windows = -(-(n_fft // 2 + 1) // BF16_WINDOW)
    cw = 1
    while cw < min(windows, BF16_MAX_CW):
        cw *= 2
    kp = _round_up(n_live, BF16_K)
    ring = BF16_STAGES * _BF16_STAGE
    fixed = 1024 + ring + 16 * BF16_STAGES
    budget = _SM_SMEM // 2 - 1024 - fixed
    span, stride, kch = 0, 0, 0
    if hop % 2 == 0:
        stride = hop + (8 - hop) % 64
        a_bytes = _round_up((BF16_TILE + (kp - 1) // hop) * stride * 2, 16)
        span = int(a_bytes <= budget)
    if not span:
        kch = min(kp, (budget // (2 * BF16_TILE) - 8) // BF16_K * BF16_K)
        stride = kch + 8
        a_bytes = BF16_TILE * stride * 2
    mel_nt = -(-num_mels // 8)
    return {"windows": windows, "cw": cw, "kp": kp, "span": span, "stride": stride,
            "kch": kch, "stages": BF16_STAGES,
            "scratch": int(windows > cw or 64 * (BF16_WINDOW + 2 + num_mels) * 4 > ring),
            "a_bytes": a_bytes, "smem": fixed + a_bytes,
            "mel_nt": mel_nt if mel_nt <= 16 else 0,
            "mel_frag": windows * BF16_WINDOW * kp // 2}


@functools.lru_cache(maxsize=16)
def _radix_arg(n_fft: int):
    """(the radices as a host C int array, their count) for a launcher."""
    import ctypes

    # n_fft 2 has nothing to transform: one radix-1 (copy) stage
    r = fft_radices(n_fft // 2 if n_fft % 2 == 0 else n_fft) or (1,)
    return (ctypes.c_int * len(r))(*r), len(r)


@functools.lru_cache(maxsize=16)
def _bf16_plan_arg(n_fft: int, hop: int, n_live: int, num_mels: int):
    """``bf16_plan`` as the host C int array the launchers read."""
    import ctypes

    plan = bf16_plan(n_fft, hop, n_live, num_mels)
    return (ctypes.c_int * len(BF16_PLAN_FIELDS))(*(plan[k] for k in BF16_PLAN_FIELDS))


def db_normalize(x: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """20*log10(max(x, 1e-5)) - ref_level_db, then the normalized-dB map."""
    db = 20.0 * torch.log10(torch.clamp(x, min=1e-5)) - cfg.ref_level_db
    unit = (db - cfg.min_level_db) / (-cfg.min_level_db)
    if cfg.symmetric_norm:
        return torch.clamp(2.0 * cfg.max_abs_value * unit - cfg.max_abs_value,
                           -cfg.max_abs_value, cfg.max_abs_value)
    return torch.clamp(unit, 0.0, 1.0)


def _num_frames(cfg: AudioConfig, total: int) -> int:
    if cfg.n_fft % cfg.hop_length:
        raise ValueError("the STFT kernels need hop_length | n_fft")
    if total < cfg.n_fft:
        raise ValueError(f"STFT features: {total} samples < n_fft {cfg.n_fft}")
    return 1 + (total - cfg.n_fft) // cfg.hop_length


def mma_b_layout(b: torch.Tensor) -> torch.Tensor:
    """A (K, N) matrix (K a multiple of 16, N of 8) rounded to bfloat16 as
    the B operands of ``mma.sync.m16n8k16``: int32 (N/8, K/16, 32, 2),
    [n8 tile][k16 step][lane][register]; lane g*4 + t holds, low half first,
    B[2t, g], B[2t+1, g] in register 0 and B[2t+8, g], B[2t+9, g] in
    register 1 of the tile. A warp reads one tile's fragments as 256
    consecutive bytes."""
    k, n = b.shape
    x = b.to(torch.bfloat16).reshape(k // 16, 2, 4, 2, n // 8, 8)   # (ks, h, t, e, nt, g)
    x = x.permute(4, 0, 5, 2, 1, 3).contiguous()                   # (nt, ks, g, t, h, e)
    return x.view(torch.int32).reshape(n // 8, k // 16, 32, 2)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bfloat16 (ties to even) and back to float32: a
    plain version's bf16 operand."""
    return x.to(torch.bfloat16).to(torch.float32)


def _live_features(frames: torch.Tensor, cfg: AudioConfig, bases, normalize_linear: bool,
                   bf16_bases: bool = False, bf16_mel: bool = False) -> Features:
    """(..., n_live) frames' live taps -> (mel, linear): two products against
    the window-baked bases, the magnitude, the mel product, dB.
    ``bf16_bases`` rounds the frames and the bases to bfloat16,
    ``bf16_mel`` the magnitude and the mel basis for the mel product (the
    linear output keeps the float32 magnitude); the products of bf16 values
    are exact in float32, so the float32 sums compute the bf16 modes."""
    nf = cfg.num_freq
    cos_b, sin_b = dft_bases(cfg, str(frames.device))
    mel_t = bases["mel_t"][:nf]
    if bf16_bases:
        frames, cos_b, sin_b = round_bf16(frames), round_bf16(cos_b), round_bf16(sin_b)
    re = frames @ cos_b
    im = frames @ sin_b
    mag = torch.sqrt(re * re + im * im)
    mel = round_bf16(mag) @ round_bf16(mel_t) if bf16_mel else mag @ mel_t
    return db_normalize(mel, cfg), (db_normalize(mag, cfg) if normalize_linear else mag)


def stft_features_plain(wav: torch.Tensor, cfg: AudioConfig, bases=None, *,
                        normalize_linear: bool = True, bf16_bases: bool = False,
                        bf16: bool = False) -> Features:
    """The plain version of K3 and K3′ (one function, computed whole here):
    hop-chunk framing of the live taps, then ``_live_features``.
    ``bf16_bases`` is K3′'s mode (the mel stays float32), ``bf16`` K3's (the
    bases and the mel product on bf16 operands)."""
    hop = cfg.hop_length
    t = _num_frames(cfg, wav.shape[-1])
    bases = bases or stft_bases(cfg, wav.device)
    j0, j1, _ = live_tap_span(cfg)
    num_chunks = wav.shape[-1] // hop
    chunks = wav[:, : num_chunks * hop].reshape(wav.shape[0], num_chunks, hop)
    frames = torch.cat([chunks[:, j: j + t] for j in range(j0, j1)], dim=-1)
    return _live_features(frames, cfg, bases, normalize_linear, bf16_bases or bf16, bf16)


def stft_features_frames_plain(frames: torch.Tensor, cfg: AudioConfig, bases=None, *,
                               normalize_linear: bool = True) -> Features:
    """The plain version of K3″: the live columns of (F, n_fft) raw frames,
    then ``_live_features``."""
    bases = bases or stft_bases(cfg, frames.device)
    j0, _, n_live = live_tap_span(cfg)
    n0 = j0 * cfg.hop_length
    return _live_features(frames[:, n0: n0 + n_live], cfg, bases, normalize_linear)


def _norm_args(cfg: AudioConfig, normalize_linear: bool):
    return (float(cfg.ref_level_db), float(cfg.min_level_db), float(cfg.max_abs_value),
            int(cfg.symmetric_norm), int(normalize_linear))


def _wav_launch_args(wav: torch.Tensor, cfg: AudioConfig, bases, name: str, tables):
    """Checks and outputs shared by the two wav-input kernels (K3, K3′);
    ``tables`` names the kernel's entries of ``bases``."""
    if wav.dim() != 2:
        raise ValueError(f"{name}: expected (B, L) wav, got shape {tuple(wav.shape)}")
    b, total = wav.shape
    t = _num_frames(cfg, total)
    bases = bases or stft_bases(cfg, wav.device)
    wav = wav.to(torch.float32).contiguous()
    check_cuda(name, wav, *(bases[k] for k in tables))
    mel = torch.empty(b, t, cfg.num_mels, device=wav.device, dtype=torch.float32)
    lin = torch.empty(b, t, cfg.num_freq, device=wav.device, dtype=torch.float32)
    return wav, bases, mel, lin


def _launch_wav(kernel: CudaKernel, name: str, wav: torch.Tensor, cfg: AudioConfig, bases,
                normalize_linear: bool, bf16_bases: bool = False) -> Features:
    """One launch of K3 or K3′ (``kernel``) on a CUDA wav: float32 through
    the FFT (in shared memory, or on a device-memory scratch past
    ``MAX_FFT_SIZE``), or on bf16 operands (K3′'s bf16 bases, K3's bf16
    mode, counted as its ``bf16`` branch) on the wgmma kernel of
    ``bf16_plan``."""
    refuse_grad(name, wav)
    wav, bases, mel, lin = _wav_launch_args(wav, cfg, bases, name, _FFT_TABLES)
    b, total = wav.shape
    if b == 0:
        return mel, lin
    if b > 65535:
        raise ValueError(f"{name}: batch {b} > 65535")
    t = mel.shape[1]
    j0, _, n_live = live_tap_span(cfg)
    slots, scratch, bf16_args = 0, None, (None, None)
    if bf16_bases:
        fr = 0
        plan = bf16_plan(cfg.n_fft, cfg.hop_length, n_live, cfg.num_mels)
        wb = _bf16_bases(cfg, str(wav.device))
        if plan["scratch"]:     # the magnitudes of every window, past 8 windows
            scratch = torch.empty(b, t, plan["windows"] * BF16_WINDOW, device=wav.device,
                                  dtype=torch.float32)
        check_cuda(name, wb, scratch)
        bf16_args = (ptr(wb), _bf16_plan_arg(cfg.n_fft, cfg.hop_length, n_live, cfg.num_mels))
    else:
        fr = fft_frames_per_block(cfg.n_fft, b, t, sm_count(wav.device.index))
        slots, scratch = _fft_scratch(cfg.n_fft, b, t, fr, wav.device)
    radix, stages = _radix_arg(cfg.n_fft)
    tables = [ptr(bases[k]) for k in _FFT_TABLES]
    sizes = [ptr(mel), ptr(lin), b, total, t, cfg.hop_length, j0 * cfg.hop_length, n_live,
             cfg.n_fft, cfg.num_mels, fr, slots, radix, stages,
             *_norm_args(cfg, normalize_linear)]
    branch = "bf16" if bf16_bases and kernel is KERNEL else None
    kernel(ptr(wav), *tables, *bf16_args, *sizes, int(bf16_bases), ptr(scratch),
           stream_ptr(wav.device), branch=branch)
    return mel, lin


def stft_features(wav: torch.Tensor, cfg: AudioConfig, bases=None, *,
                  normalize_linear: bool = True, bf16: bool = False) -> Features:
    """K3: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors, for any hop | n_fft. ``bases``
    (from ``stft_bases``) may be passed to reuse the device copies.
    ``bf16`` is the resident Pallas kernel's bf16 operand mode: frames and
    window-baked bases rounded to bfloat16 with float32 sums, then the
    magnitude and the mel basis rounded to bfloat16 for the mel product. It
    differs from K3′'s ``bf16_bases`` by that mel product."""
    if wav.device.type == "cpu":
        return stft_features_plain(wav, cfg, bases, normalize_linear=normalize_linear,
                                   bf16=bf16)
    return _launch_wav(KERNEL, "stft_features", wav, cfg, bases, normalize_linear, bf16)


def stft_features_fused(wav: torch.Tensor, cfg: AudioConfig, bases=None, *,
                        normalize_linear: bool = True, bf16_bases: bool = False
                        ) -> Features:
    """K3′: K3's function for any hop | n_fft through K3's kernel, with its
    own launcher and counter. ``bf16_bases`` rounds the frames and the
    window-baked cos/sin bases to bfloat16 and sums their products in float32
    on the tensor cores (the mel stays float32). The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if wav.device.type == "cpu":
        return stft_features_plain(wav, cfg, bases, normalize_linear=normalize_linear,
                                   bf16_bases=bf16_bases)
    return _launch_wav(FUSED_KERNEL, "stft_features_fused", wav, cfg, bases,
                       normalize_linear, bf16_bases)


def stft_features_frames(frames: torch.Tensor, cfg: AudioConfig, bases=None, *,
                         normalize_linear: bool = True) -> Features:
    """K3″: (F, n_fft) raw (un-windowed) frames -> (mel (F, M), linear
    (F, NF)), through the mixed-radix FFT (in shared memory, or on a
    device-memory scratch past ``MAX_FFT_SIZE``). The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if frames.dim() != 2 or frames.shape[1] != cfg.n_fft:
        raise ValueError(f"stft_features_frames: expected (F, {cfg.n_fft}) frames, "
                         f"got shape {tuple(frames.shape)}")
    if frames.device.type == "cpu":
        return stft_features_frames_plain(frames, cfg, bases,
                                          normalize_linear=normalize_linear)
    refuse_grad("stft_features_frames", frames)
    n = frames.shape[0]
    check_fft_size(cfg)
    bases = bases or stft_bases(cfg, frames.device)
    frames = frames.to(torch.float32).contiguous()
    check_cuda("stft_features_frames", frames, *(bases[k] for k in _FFT_TABLES))
    mel = torch.empty(n, cfg.num_mels, device=frames.device, dtype=torch.float32)
    lin = torch.empty(n, cfg.num_freq, device=frames.device, dtype=torch.float32)
    if n == 0:
        return mel, lin
    fr = fft_frames_per_block(cfg.n_fft, 1, n, sm_count(frames.device.index))
    slots, scratch = _fft_scratch(cfg.n_fft, 1, n, fr, frames.device)
    radix, stages = _radix_arg(cfg.n_fft)
    j0, _, n_live = live_tap_span(cfg)
    FRAMES_KERNEL(ptr(frames), ptr(bases["fft_twiddle"]), ptr(bases["fft_window"]),
                  ptr(bases["mel_lo"]), ptr(bases["mel_off"]), ptr(bases["mel_w"]),
                  ptr(mel), ptr(lin), n, cfg.n_fft, j0 * cfg.hop_length, n_live,
                  cfg.num_mels, fr, slots, radix, stages, *_norm_args(cfg, normalize_linear),
                  ptr(scratch), stream_ptr(frames.device))
    return mel, lin


class KernelDSP:
    """Counterpart of ``PallasDSP``: a drop-in for ``TorchDSP.features`` that
    runs preemphasis and reflect-centred framing in plain PyTorch, then K3″
    on the flattened (B*T, n_fft) frames."""

    def __init__(self, cfg: AudioConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._dsp = TorchDSP(cfg, self.device)
        self._bases = stft_bases(cfg, self.device)

    def features(self, wav: torch.Tensor) -> Features:
        """(B, S) raw wav -> (mel (B, T, M), linear (B, T, NF))."""
        wav = wav.to(self.device, torch.float32)
        frames = self._dsp._frame(self._dsp.preemphasis(wav))    # (B, T, n_fft)
        b, t, n = frames.shape
        mel, lin = stft_features_frames(frames.reshape(b * t, n), self.cfg, self._bases)
        return mel.reshape(b, t, self.cfg.num_mels), lin.reshape(b, t, self.cfg.num_freq)

    def mel_spectrogram(self, wav: torch.Tensor) -> torch.Tensor:
        return self.features(wav)[0]

    def linear_spectrogram(self, wav: torch.Tensor) -> torch.Tensor:
        return self.features(wav)[1]
