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

from ..models.modules import sigmoid
from .build import I, P, CudaKernel, check_cuda, ptr, refuse_grad, stream_ptr

KERNEL = CudaKernel("gru_scan.cu", "gru_scan_launch",
                    [P, P, I, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                     I, I, I, I, I, I, P])
# the register form's batch rows a cluster and most lanes a unit; the
# recurrent weights a lane holds for each gate (8 was faster than 4 and 16
# at H = 128 on an H100, PERF.md): 8 up to H = 128, 16 up to H = 256; 8
# CTAs, the portable cluster size; the streamed form's threads
ROWS, MAX_SLICES, MAX_CLUSTER, STREAM_THREADS = 4, 16, 8, 256
SLICE_LENS = (8, 16)
_MAX_GRID_Y = 65535
_MAX_SMEM = 232448


def _stream_smem(hidden: int, units: int, kp: int, rows: int) -> int:
    """Shared memory of the streamed form (``csrc/gru_scan.cu::
    gru_stream_floats``): the double-buffered state of ``rows`` rows, the
    ``kp`` partial sums of every gate of the CTA's units, two mbarriers."""
    return 4 * ((2 * rows * hidden + kp * rows * 3 * units + 1) & ~1) + 16


def launch_plan(batch: int, hidden: int) -> Dict[str, int]:
    """K1's recurrence launch for B = ``batch`` rows of H = ``hidden`` units:
    ``cluster`` C CTAs a cluster (min(8, H)), ``units`` ceil(H / C) a CTA.
    Up to H = 256 the register form: ``ks`` recurrent weights a lane a gate
    (8 up to H = 128, else 16), ``slices`` S lanes a unit (ceil(H / ks)
    rounded up to a power of two, at least 4: after the reduction each lane
    owns one of the 4 rows), ``threads`` units * S rounded up to a warp,
    ``rows`` 4 batch rows a cluster. Past it the streamed form (``ks`` 0):
    256 threads, ``kp`` k parts of the sums (8 warps over the CTA's groups of
    32 units), ``rows`` 4, 2 or 1, the most whose state fits shared memory.
    ``clusters`` ceil(B / rows) a direction, ``smem`` the bytes of shared
    memory. Raises ValueError on a shape no form takes (H < 1, too many
    rows, or one row's state past shared memory: H > 24465; its weights
    alone would then be 7.2 GB)."""
    if hidden < 1 or batch < 0:
        raise ValueError(f"gru_scan: no launch for B={batch}, H={hidden}")
    cluster = min(MAX_CLUSTER, hidden)
    units = -(-hidden // cluster)
    if hidden <= SLICE_LENS[-1] * MAX_SLICES:
        ks = SLICE_LENS[0] if hidden <= SLICE_LENS[0] * MAX_SLICES else SLICE_LENS[1]
        slices = max(ROWS, 1 << max(0, -(-hidden // ks) - 1).bit_length())
        threads, kp, rows = -(-units * slices // 32) * 32, 0, ROWS
        smem = 4 * 2 * ROWS * slices * ks + 16
    else:
        ks, slices, threads = 0, 0, STREAM_THREADS
        kp = max(1, (STREAM_THREADS // 32) // -(-units // 32))
        rows = next((r for r in (ROWS, 2, 1)
                     if _stream_smem(hidden, units, kp, r) <= _MAX_SMEM), 0)
        if not rows:
            raise ValueError(f"gru_scan: no launch for B={batch}, H={hidden}: one row's "
                             f"state needs {_stream_smem(hidden, units, kp, 1)} bytes of "
                             "shared memory")
        smem = _stream_smem(hidden, units, kp, rows)
    clusters = -(-batch // rows)
    # a BiGRU's two directions stack their clusters on the grid's y axis
    if 2 * clusters > _MAX_GRID_Y:
        raise ValueError(f"gru_scan: B={batch} needs {clusters} clusters a direction, "
                         f"more than {_MAX_GRID_Y // 2}")
    return {"cluster": cluster, "units": units, "ks": ks, "slices": slices,
            "threads": threads, "kp": kp, "rows": rows, "clusters": clusters, "smem": smem}


def gru_update(gx: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One Keras-v2 GRU step from the input and recurrent gate
    pre-activations ``gx``, ``gh`` (..., 3H) and the state ``h`` (..., H)."""
    xz, xr, xn = gx.chunk(3, dim=-1)
    hz, hr, hn = gh.chunk(3, dim=-1)
    z = sigmoid(xz + hz)
    r = sigmoid(xr + hr)
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
    refuse_grad(name, xs, *(x for dr in dirs for x in dr))
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
           plan["ks"], plan["slices"], plan["threads"], plan["kp"], plan["rows"], plan["smem"],
           stream_ptr(xs.device))
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
