"""K1: masked Keras-v2 GRU sequence scan (counterpart of ``ops/gru_pallas.py``).

``gru_scan`` launches ``csrc/gru_scan.cu`` for CUDA tensors and runs
``gru_scan_plain`` for CPU tensors. Both return ``(ys (B, T, H), final
(B, H))`` with the contract of ``gst_tacotron_tpu.ops.gru_pallas``: gate order
z, r, n with reset_after; a step at or past a row's length holds the state
and its ``ys`` row repeats the held state; ``reverse`` walks the sequence
backwards with the mask flipped alongside it. ``bigru_scan`` runs both
directions of a BiGRU in one launch, each with the bits of its own
``gru_scan``. ``launch_plan`` sizes the kernel's clusters.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .build import I, P, CudaKernel, check_cuda, ptr, stream_ptr

KERNEL = CudaKernel("gru_scan.cu", "gru_scan_launch",
                    [P, P, I, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                     I, I, P])
# the kernel's GRU_ROWS and GRU_KS (recurrent weights a lane holds for each
# gate; 8 was faster than 4 and 16 at H = 128 on an H100, PERF.md), the most
# lanes a unit (16, so H <= 128), and 8 CTAs, the portable cluster size
ROWS, SLICE_LEN, MAX_SLICES, MAX_CLUSTER = 4, 8, 16, 8
_MAX_GRID_Y = 65535


def launch_plan(batch: int, hidden: int) -> Dict[str, int]:
    """K1's recurrence launch for B = ``batch`` rows of H = ``hidden`` units:
    ``cluster`` C CTAs a cluster (min(8, H)), ``units`` ceil(H / C) a CTA,
    ``slices`` S lanes a unit, each holding 8 recurrent weights a gate
    (ceil(H / 8) rounded up to a power of two, at least 4: after the
    reduction each lane owns one of the 4 rows), ``threads`` units * S
    rounded up to a warp, ``rows`` 4 batch rows a cluster, ``clusters``
    ceil(B / 4) a direction, ``smem`` the double-buffered state and its two
    mbarriers in bytes. Raises ValueError on a shape the kernel cannot take
    (H > 128, or too many rows)."""
    if not 1 <= hidden <= SLICE_LEN * MAX_SLICES or batch < 0:
        raise ValueError(f"gru_scan: no launch for B={batch}, H={hidden}: the kernel "
                         f"takes 1 <= H <= {SLICE_LEN * MAX_SLICES}")
    cluster = min(MAX_CLUSTER, hidden)
    units = -(-hidden // cluster)
    slices = max(ROWS, 1 << max(0, -(-hidden // SLICE_LEN) - 1).bit_length())
    clusters = -(-batch // ROWS)
    # a BiGRU's two directions stack their clusters on the grid's y axis
    if 2 * clusters > _MAX_GRID_Y:
        raise ValueError(f"gru_scan: B={batch} needs {clusters} clusters a direction, "
                         f"more than {_MAX_GRID_Y // 2}")
    return {"cluster": cluster, "units": units, "slices": slices,
            "threads": -(-units * slices // 32) * 32, "rows": ROWS, "clusters": clusters,
            "smem": 4 * 2 * ROWS * slices * SLICE_LEN + 16}


def gru_update(gx: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One Keras-v2 GRU step from the input and recurrent gate
    pre-activations ``gx``, ``gh`` (..., 3H) and the state ``h`` (..., H)."""
    xz, xr, xn = gx.chunk(3, dim=-1)
    hz, hr, hn = gh.chunk(3, dim=-1)
    z = torch.sigmoid(xz + hz)
    r = torch.sigmoid(xr + hr)
    n = torch.tanh(xn + r * hn)
    return z * h + (1.0 - z) * n


def gru_scan_plain(xs: torch.Tensor, h0: torch.Tensor, wi: torch.Tensor,
                   bi: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor, *,
                   lengths: Optional[torch.Tensor] = None,
                   reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same scan in plain PyTorch, one step per loop iteration."""
    b, t, _ = xs.shape
    gx_all = xs @ wi + bi                                   # (B, T, 3H)
    if lengths is None:
        valid = torch.ones(b, t, dtype=torch.bool, device=xs.device)
    else:
        valid = (torch.arange(t, device=xs.device)[None, :]
                 < lengths.to(xs.device)[:, None])
    h = h0
    ys = [None] * t
    steps = range(t - 1, -1, -1) if reverse else range(t)
    for i in steps:
        h_new = gru_update(gx_all[:, i], h @ wh + bh, h)
        h = torch.where(valid[:, i, None], h_new, h)
        ys[i] = h
    return torch.stack(ys, dim=1), h


Direction = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _launch(xs: torch.Tensor, dirs: Sequence[Direction], lengths: Optional[torch.Tensor],
            reverse: bool, name: str):
    """One kernel call for one direction (``reverse`` as given) or both of a
    BiGRU (forward, then reverse): (ys (B, T, len(dirs) * H), finals)."""
    b, t, d = xs.shape
    hdim = dirs[0][0].shape[-1]
    for h0, wi, bi, wh, bh in dirs:
        if h0.shape != (b, hdim) or wi.shape != (d, 3 * hdim) or wh.shape != (hdim, 3 * hdim):
            raise ValueError(f"{name}: shapes h0 {tuple(h0.shape)}, wi {tuple(wi.shape)}, "
                             f"wh {tuple(wh.shape)} do not fit B={b}, D={d}, H={hdim}")
    plan = launch_plan(b, hdim)
    xs = xs.contiguous()
    dirs = [(h0.contiguous(), wi, bi, wh, bh) for h0, wi, bi, wh, bh in dirs]
    lens = None if lengths is None else lengths.to(xs.device, torch.int32).contiguous()
    check_cuda(name, xs, lens, *(x for dr in dirs for x in dr))
    n = len(dirs)
    ys = torch.empty(b, t, n * hdim, device=xs.device, dtype=torch.float32)
    finals = [torch.empty(b, hdim, device=xs.device, dtype=torch.float32) for _ in dirs]
    gx_scratch = torch.empty(n, b, t, 3 * hdim, device=xs.device, dtype=torch.float32)
    if b == 0:
        return ys, finals
    (h0a, wia, bia, wha, bha), (h0b, wib, bib, whb, bhb) = dirs[0], dirs[-1]
    KERNEL(ptr(xs), ptr(lens), n, ptr(h0a), ptr(h0b), ptr(wia), ptr(wib), ptr(bia), ptr(bib),
           ptr(wha), ptr(whb), ptr(bha), ptr(bhb), ptr(ys), ptr(finals[0]), ptr(finals[-1]),
           ptr(gx_scratch), b, t, d, hdim, int(reverse), plan["cluster"], plan["units"],
           plan["slices"], plan["threads"], stream_ptr(xs.device))
    return ys, finals


def gru_scan(xs: torch.Tensor, h0: torch.Tensor, wi: torch.Tensor,
             bi: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor, *,
             lengths: Optional[torch.Tensor] = None,
             reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU scan: the CUDA kernel for CUDA tensors (one launch: the input
    GEMM and the clustered recurrence of ``launch_plan``), the plain version
    for CPU tensors."""
    if xs.device.type == "cpu":
        return gru_scan_plain(xs, h0, wi, bi, wh, bh, lengths=lengths,
                              reverse=reverse)
    ys, (final,) = _launch(xs, [(h0, wi, bi, wh, bh)], lengths, reverse, "gru_scan")
    return ys, final


def bigru_scan(xs: torch.Tensor, fwd: Direction, bwd: Direction, *,
               lengths: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Both directions of a BiGRU, each ``(h0, wi, bi, wh, bh)``: (concat
    [forward ys, backward ys] (B, T, 2H), (forward final, backward final)),
    the results of ``gru_scan`` forward and reverse. On the card one launch
    runs both directions side by side, as independent clusters; on the CPU
    the plain version runs twice."""
    if xs.device.type == "cpu":
        f, f_final = gru_scan_plain(xs, *fwd, lengths=lengths)
        b, b_final = gru_scan_plain(xs, *bwd, lengths=lengths, reverse=True)
        return torch.cat([f, b], dim=-1), (f_final, b_final)
    ys, (f_final, b_final) = _launch(xs, [fwd, bwd], lengths, False, "bigru_scan")
    return ys, (f_final, b_final)
