"""The three mel-STFT kernels (counterparts of ``gst_tacotron_tpu/ops/stft_pallas.py``).

All three compute normalized-dB mel and linear features of the window's
live taps, through the mixed-radix FFT of ``csrc/fft.cuh`` (plan and table
from ``fft_plan``; any hop | n_fft, each transform in shared memory or, past
``MAX_FFT_SIZE``, in a device-memory scratch) and a sparse mel over each
filter's nonzero bins, in one launch:

  K3   ``stft_features``        <- ``stft_features_pallas_resident``:
       (B, L) wav (``csrc/stft_features.cu``); ``bf16`` is the resident
       kernel's bf16 operand mode (frames and bases, then magnitudes and the
       mel basis, rounded to bfloat16, float32 sums), on K3′'s tensor-core
       kernel with a bf16 mel;
  K3′  ``stft_features_fused``  <- ``stft_features_pallas_fused``: the same
       function through the same kernel (``csrc/stft_wav.cuh``), with its own
       launcher and counter; ``bf16_bases`` runs the window-baked DFT
       products on the tensor cores instead (``csrc/stft_fused.cu``);
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
             F, F, F, I, I, I, I, P, P]
KERNEL = CudaKernel("stft_features.cu", "stft_features_launch", _WAV_ARGS, branches=("bf16",))
FUSED_KERNEL = CudaKernel("stft_fused.cu", "stft_fused_launch", _WAV_ARGS)
FRAMES_KERNEL = CudaKernel("stft_frames.cu", "stft_frames_launch",
                           [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, I, F, F, F, I, I,
                            P, P])
# the bins of a bf16 window (8 warps x 16 bins) and the plain bases' padding
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


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """The bfloat16 bits (uint16) of x rounded to nearest, ties to even: the
    rounding of ``round_bf16`` (torch's cast)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def mma_b_fragments(b: np.ndarray) -> np.ndarray:
    """A (K, N) float32 matrix as the B operands of ``mma.sync.m16n8k16``
    bf16 (K padded with zero rows to a multiple of 16, N a multiple of 8):
    int32 (N/8, K/16, 32, 2), [n8 tile][k16 step][lane][register]; lane
    g*4 + t holds, low half first, B[2t, g], B[2t+1, g] in register 0 and
    B[2t+8, g], B[2t+9, g] in register 1 of the tile. A warp reads one tile's
    fragments as 256 consecutive bytes."""
    k, n = b.shape
    if n % 8:
        raise ValueError(f"mma_b_fragments: N {n} is not a multiple of 8")
    kp = _round_up(max(k, 1), 16)
    bits = np.zeros((kp, n), np.uint32)
    bits[:k] = bf16_bits(b)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    ks = np.arange(kp // 16)[:, None]
    nt = np.arange(n // 8)[:, None, None]
    col = nt * 8 + g                                     # (NT, 1, 32)
    row = ks * 16 + 2 * t                                # (KS, 32)
    reg0 = bits[row, col] | (bits[row + 1, col] << 16)
    reg1 = bits[row + 8, col] | (bits[row + 9, col] << 16)
    return np.stack([reg0, reg1], -1).astype(np.uint32).view(np.int32)


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
def _bf16_fragments(cfg: AudioConfig, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3′'s bf16 B fragments of the window-baked cos/sin bases on
    ``device``, built at the first ``bf16_bases`` call and kept."""
    cos_b, sin_b, _ = _bases_np(cfg)
    return (torch.from_numpy(mma_b_fragments(cos_b)).to(device),
            torch.from_numpy(mma_b_fragments(sin_b)).to(device))


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


BF16_TILE = 16                # frames a K3′ bf16 tile (one m16 row tile of mma.sync)
BF16_CLUSTERS = (2, 4, 8)     # CTAs a tile's cluster, each 1/cw of its 128-bin windows


def bf16_smem(n_fft: int, cw: int = 2) -> int:
    """Shared memory of a K3′ bf16 CTA in clusters of ``cw`` (mirrors
    ``csrc/stft_fused.cu::bf16_smem``): 8 warps' rings of 4 k16 steps of B
    fragments (1 KB each), the tile's 1024 resident taps in bf16 (rows of
    1032), the magnitudes of its 1/cw of the 128-bin windows (rows of 136)
    and the full magnitude rows of its 16 / cw mel frames."""
    windows = -(-(n_fft // 2 + 1) // FREQ_TILE)
    return (8 * 4 * 1024 + 2 * BF16_TILE * 1032
            + 4 * -(-windows // cw) * BF16_TILE * 136
            + 4 * -(-BF16_TILE // cw) * windows * FREQ_TILE)


def bf16_cluster(n_fft: int) -> int:
    """The bf16 cluster width for ``n_fft``: the narrowest of
    ``BF16_CLUSTERS`` whose CTA fits one block (2 up to n_fft 4863, 4 up to
    9727, 8 up to 19711); ValueError naming n_fft past that."""
    for cw in BF16_CLUSTERS:
        if bf16_smem(n_fft, cw) <= _MAX_SMEM:
            return cw
    raise ValueError(f"stft_features_fused: bf16_bases at n_fft {n_fft} needs "
                     f"{bf16_smem(n_fft, BF16_CLUSTERS[-1])} bytes of shared memory at "
                     f"clusters of {BF16_CLUSTERS[-1]}, more than one block has")



@functools.lru_cache(maxsize=16)
def _radix_arg(n_fft: int):
    """(the radices as a host C int array, their count) for a launcher."""
    import ctypes

    # n_fft 2 has nothing to transform: one radix-1 (copy) stage
    r = fft_radices(n_fft // 2 if n_fft % 2 == 0 else n_fft) or (1,)
    return (ctypes.c_int * len(r))(*r), len(r)


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
    mode, counted as its ``bf16`` branch) on clusters of
    ``bf16_cluster(n_fft)`` CTAs."""
    refuse_grad(name, wav)
    cw = bf16_cluster(cfg.n_fft) if bf16_bases else 0    # the size limit, before any table
    wav, bases, mel, lin = _wav_launch_args(wav, cfg, bases, name, _FFT_TABLES)
    b, total = wav.shape
    if b == 0:
        return mel, lin
    if b > 65535:
        raise ValueError(f"{name}: batch {b} > 65535")
    t = mel.shape[1]
    slots, scratch, frags = 0, None, (None, None)
    if bf16_bases:
        fr, (bcos, bsin) = BF16_TILE, _bf16_fragments(cfg, str(wav.device))
        frags = (ptr(bcos), ptr(bsin))
    else:
        fr = fft_frames_per_block(cfg.n_fft, b, t, sm_count(wav.device.index))
        slots, scratch = _fft_scratch(cfg.n_fft, b, t, fr, wav.device)
    radix, stages = _radix_arg(cfg.n_fft)
    j0, _, n_live = live_tap_span(cfg)
    tables = [ptr(bases[k]) for k in _FFT_TABLES]
    sizes = [ptr(mel), ptr(lin), b, total, t, cfg.hop_length, j0 * cfg.hop_length, n_live,
             cfg.n_fft, cfg.num_mels, fr, slots, radix, stages,
             *_norm_args(cfg, normalize_linear)]
    branch = "bf16" if bf16_bases and kernel is KERNEL else None
    kernel(ptr(wav), *tables, *frags, *sizes, int(bf16_bases), cw, ptr(scratch),
           stream_ptr(wav.device), branch=branch)
    return mel, lin


def stft_features(wav: torch.Tensor, cfg: AudioConfig, bases=None, *,
                  normalize_linear: bool = True, bf16: bool = False) -> Features:
    """K3: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors, for any hop | n_fft (``bf16``: n_fft up to 19711). ``bases``
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
    on the tensor cores (the mel stays float32; n_fft up to 19711). The
    kernel for CUDA tensors, the plain version for CPU tensors."""
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
