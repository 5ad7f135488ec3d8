"""Griffin-Lim's bf16 iterations on the card (``csrc/griffin_lim.cu``).

``TorchDSP.griffin_lim`` runs its iterations here for a CUDA magnitude when
``audio.griffin_lim_bf16`` is set, and its own plain loop
(``TorchDSP.griffin_lim_iterations_plain``) otherwise: on the CPU, where it is
the oracle, and in float32. ``griffin_lim_iterations`` takes the start
spectrum and returns the last projected one, the plain loop's function: the
real-pair DFT products over the window's live taps on bfloat16 operands
(the momentum-extrapolated spectrum, the frames of the normalised,
reflect-padded wave) with float32 sums and float32 state. Each iteration is
one call of the launcher, three launches: G1 the inverse product, G2 the
overlap-add, G3 the forward product with the magnitude projection and the
next momentum step in its epilogue (the design is in the source). It counts
``griffin_lim_kernel_iters``, as the plain loop counts
``griffin_lim_plain_iters``.

The kernel's operands interleave re and im: the spectrum operand is (rows,
2F) bf16 with bin f's re and im in columns 2f, 2f + 1 (``spectrum_operand``),
and the bases' rows (``kernel_bases``) are the plain loop's bf16 bases
reordered to match. The magnitude and the float32 state stay in G3's tile
order for the whole call (``tile_order``, ``row_order``), so each G3 CTA
reads and writes one contiguous block. ``emulate_iteration`` computes one
iteration through the operand layouts and the kernels' index maps in plain
PyTorch, for the CPU tests.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import AudioConfig
from ..dsp.ref import live_tap_span
from ..dsp.torch_dsp import _dft_bases_np
from ..utils.profiling import count
from .build import F, I, P, CudaKernel, check_cuda, ptr, refuse_grad, stream_ptr

KERNEL = CudaKernel("griffin_lim.cu", "griffin_lim_iteration_launch",
                    [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, F, I, P])
# the kernels' tiles (csrc/griffin_lim.cu): 128 rows a tile, 64 k a ring
# stage, G1 256 taps a tile, G3 64 bins ((re, im) columns: 128) a tile
TILE_M, TILE_K, INV_TILE_N, FWD_TILE_BINS = 128, 64, 256, 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=16)
def gl_plan(cfg: AudioConfig) -> Dict[str, int]:
    """The kernels' sizes for ``cfg``; raises ValueError for a configuration
    they do not take: hop must be a multiple of 64 (a k-step of G3 is one
    box of a hop-long chunk) and divide n_fft. ``n_live`` taps from chunk
    ``j0``; ``k1`` G1's depth (2F rounded up to 64); ``ldspec`` the operand's
    row (2F rounded up to 8: 16-byte rows); ``inv_rows`` and ``fwd_rows`` the
    bases' rows (whole tiles, zero past the taps and the bins); ``bin_tiles``
    G3's tiles of 64 bins."""
    hop, n_fft, nf = cfg.hop_length, cfg.n_fft, cfg.num_freq
    if hop < TILE_K or hop % TILE_K or n_fft % hop:
        raise ValueError(f"griffin_lim kernel: hop_length {hop} must be a multiple of "
                         f"{TILE_K} and divide n_fft {n_fft}")
    j0, _, n_live = live_tap_span(cfg)
    return {"j0": j0, "nk": n_live // hop, "n_live": n_live, "k1": _round_up(2 * nf, TILE_K),
            "ldspec": _round_up(2 * nf, 8), "inv_rows": _round_up(n_live, INV_TILE_N),
            "fwd_rows": _round_up(nf, FWD_TILE_BINS) * 2, "bin_tiles": -(-nf // FWD_TILE_BINS)}


def kernel_bases_np(cfg: AudioConfig) -> Tuple[np.ndarray, np.ndarray]:
    """The plain loop's float32 bases (``_dft_bases_np``: forward (n_live,
    2F), inverse (2F, n_live)) in the kernels' layouts: the inverse
    (inv_rows, k1), tap n's row holding bin f's re and im weights in columns
    2f and 2f + 1; the forward (fwd_rows, n_live), bin f's cos and -sin taps
    in rows 2f and 2f + 1; zero elsewhere."""
    plan, nf = gl_plan(cfg), cfg.num_freq
    fwd, inv = _dft_bases_np(cfg)
    n_live = plan["n_live"]
    inv_k = np.zeros((plan["inv_rows"], plan["k1"]), np.float32)
    inv_k[:n_live, 0:2 * nf:2] = inv[:nf].T
    inv_k[:n_live, 1:2 * nf:2] = inv[nf:].T
    fwd_k = np.zeros((plan["fwd_rows"], n_live), np.float32)
    fwd_k[0:2 * nf:2] = fwd[:, :nf].T
    fwd_k[1:2 * nf:2] = fwd[:, nf:].T
    return inv_k, fwd_k


@functools.lru_cache(maxsize=4)
def kernel_bases(cfg: AudioConfig, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernel_bases_np`` on ``device``, each value rounded once to
    bfloat16 as ``TorchDSP.bf16_bases`` rounds it; built at the first call
    and kept."""
    return tuple(torch.from_numpy(b).to(device).to(torch.bfloat16)
                 for b in kernel_bases_np(cfg))


def spectrum_operand(spectrum: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """G1's operand of a (B, T, F, 2) spectrum (re, im last): (rows, ldspec)
    bf16, row b*T + t holding bin f's re and im (rounded to bfloat16) in
    columns 2f and 2f + 1; zero past 2F and in the rows past B*T (up to a
    whole tile)."""
    b, t, nf, _ = spectrum.shape
    spec = torch.zeros(_round_up(b * t, TILE_M), gl_plan(cfg)["ldspec"],
                       dtype=torch.bfloat16, device=spectrum.device)
    spec[:b * t, :2 * nf] = spectrum.reshape(b * t, 2 * nf)
    return spec


def tile_order(x: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """A (B, T, F) or (B, T, F, 2) float32 tensor in G3's tile order: (bin
    tiles, B*T, 64) or (bin tiles, B*T, 64, 2), zero past F: the 128 rows
    of 64 bins a G3 CTA reads and writes are one contiguous block."""
    b, t, nf = x.shape[:3]
    n, rest = gl_plan(cfg)["bin_tiles"], tuple(x.shape[3:])
    padded = x.new_zeros((b * t, n * FWD_TILE_BINS) + rest)
    padded[:, :nf] = x.reshape((b * t, nf) + rest)
    return padded.view((b * t, n, FWD_TILE_BINS) + rest).transpose(0, 1).contiguous()


def row_order(x: torch.Tensor, b: int, t: int, nf: int) -> torch.Tensor:
    """``tile_order``'s inverse: (bin tiles, B*T, 64, 2) -> (B, T, F, 2)."""
    n = x.shape[0]
    return x.permute(1, 0, 2, 3).reshape(b, t, n * FWD_TILE_BINS, 2)[:, :, :nf]


def emulate_iteration(dsp, magnitude: torch.Tensor, state: torch.Tensor,
                      spec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One iteration through the kernels' layouts and index maps, in plain
    PyTorch (float32 sums of the bf16 operands): G1 on ``spec``, G2's
    chunk-by-chunk overlap-add with its reflect map, G3 on the wave's chunk
    rows with the projection. ``state`` is (B, T, F, 2); returns the new
    state and the next operand."""
    cfg = dsp.cfg
    plan = gl_plan(cfg)
    b, t, nf = magnitude.shape
    hop, pad, nk, j0, n_live = (cfg.hop_length, cfg.n_fft // 2, plan["nk"], plan["j0"],
                                plan["n_live"])
    inv_k, fwd_k = (torch.from_numpy(x).to(torch.bfloat16).float() for x in kernel_bases_np(cfg))
    # G1
    frames = spec[:b * t, :2 * nf].float() @ inv_k[:n_live, :2 * nf].T      # (B*T, n_live)
    frames = frames.reshape(b, t, n_live)
    # G2: the padded wave's chunks j0 .. j0 + chunks - 1
    chunks, length = t + nk - 1, hop * (t - 1)
    q = (torch.arange(chunks)[:, None] + j0) * hop + torch.arange(hop)[None, :]
    s = (q - pad).abs()
    s = torch.where(s >= length, 2 * (length - 1) - s, s)
    p = s + pad
    cp, e2 = p // hop, p % hop
    ola = torch.zeros(b, chunks, hop)
    for j in range(nk):
        r = cp - j0 - j
        ok = (r >= 0) & (r < t)
        ola = ola + torch.where(ok, frames[:, r.clamp(0, t - 1), j * hop + e2], 0.0)
    wave = (ola / dsp._win_norm(t)[p]).to(torch.bfloat16).float()            # (B, chunks, hop)
    # G3: frame r's taps are chunk rows r .. r + nk - 1
    taps = torch.cat([wave[:, j:j + t] for j in range(nk)], -1)               # (B, T, n_live)
    out = taps @ fwd_k[:2 * nf].T                                             # (B, T, 2F)
    re2, im2 = out[..., 0::2], out[..., 1::2]
    scale = magnitude / torch.clamp(torch.sqrt(re2 * re2 + im2 * im2), min=1e-16)
    re, im = re2 * scale, im2 * scale
    alpha = cfg.griffin_lim_momentum
    nxt = spectrum_operand(torch.stack((re + alpha * (re - state[..., 0]),
                                        im + alpha * (im - state[..., 1])), -1), cfg)
    return torch.stack((re, im), -1), nxt


def griffin_lim_iterations(dsp, magnitude: torch.Tensor, re: torch.Tensor, im: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dsp.cfg.griffin_lim_iters`` bf16 Griffin-Lim iterations of the (B, T,
    F) ``magnitude`` from the start spectrum (``re``, ``im``) on the card:
    the last projected (re, im). Raises for CPU tensors (the CPU runs the
    plain loop), without ``griffin_lim_bf16`` and for a configuration
    ``gl_plan`` refuses; never falls back."""
    cfg = dsp.cfg
    if not cfg.griffin_lim_bf16:
        raise ValueError("griffin_lim_iterations: the kernel runs the bf16 iterations "
                         "(audio.griffin_lim_bf16); float32 takes the plain loop")
    plan = gl_plan(cfg)
    if magnitude.device.type != "cuda":
        raise ValueError("griffin_lim_iterations: the kernel takes CUDA tensors (the CPU "
                         "runs TorchDSP.griffin_lim_iterations_plain)")
    refuse_grad("griffin_lim_iterations", magnitude, re, im)
    if magnitude.dim() != 3 or magnitude.shape[-1] != cfg.num_freq:
        raise ValueError(f"griffin_lim_iterations: expected (B, T, {cfg.num_freq}) "
                         f"magnitudes, got shape {tuple(magnitude.shape)}")
    if re.shape != magnitude.shape or im.shape != magnitude.shape:
        raise ValueError("griffin_lim_iterations: the start spectrum's shape differs from "
                         "the magnitudes'")
    b, t, nf = magnitude.shape
    hop, pad = cfg.hop_length, cfg.n_fft // 2
    if hop * (t - 1) <= pad:
        raise ValueError(f"griffin_lim_iterations: {t} frames give {hop * (t - 1)} samples, "
                         f"too few for the reflect pad of {pad}")
    start = torch.stack((re, im), -1).to(torch.float32)                       # (B, T, F, 2)
    if b == 0 or cfg.griffin_lim_iters == 0:
        return start[..., 0], start[..., 1]
    dev = magnitude.device
    mag = tile_order(magnitude.to(torch.float32), cfg)
    state = tile_order(start, cfg)
    inv_b, fwd_b = kernel_bases(cfg, str(dev))
    spec = spectrum_operand(start, cfg)
    frames = torch.empty(b * t, plan["n_live"], device=dev, dtype=torch.float32)
    wave = torch.zeros(b * (t + plan["nk"] - 1) + TILE_M, hop, device=dev,
                       dtype=torch.bfloat16)
    check_cuda("griffin_lim_iterations", mag, state, frames)
    for i in range(cfg.griffin_lim_iters):
        norm = dsp._win_norm(t)
        check_cuda("griffin_lim_iterations", norm)
        KERNEL(ptr(spec), ptr(inv_b), ptr(fwd_b), ptr(frames), ptr(norm), ptr(wave), ptr(mag),
               ptr(state), b, t, nf, plan["ldspec"], spec.shape[0], plan["n_live"], hop,
               plan["j0"], pad, plan["inv_rows"], plan["fwd_rows"],
               float(cfg.griffin_lim_momentum), int(i + 1 < cfg.griffin_lim_iters),
               stream_ptr(dev))
        count("griffin_lim_kernel_iters")
    state = row_order(state, b, t, nf)
    return state[..., 0], state[..., 1]
