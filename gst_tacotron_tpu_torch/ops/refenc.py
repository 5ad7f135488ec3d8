"""K2: the GST reference-encoder conv stack (counterpart of
``ops/refenc_pallas.py``), plus the inference composition around it.

``refenc_stack`` launches ``csrc/refenc_stack.cu`` for CUDA tensors and runs
``refenc_stack_plain`` for CPU tensors: n x (3x3 stride-2 TF-SAME conv,
folded BatchNorm, ReLU) over a (B, T, F) mel with rows past each length
zeroed first, giving (B, T', F' * C_last). One kernel takes any T, so it
serves both the batched (T % 64 == 0) and the per-element Pallas contracts.

``bf16=True`` is the batched Pallas kernel's bf16 operand mode
(``refenc_stack_pallas_batched(bf16=True)``): each layer's input and the
conv kernels rounded to bfloat16, their products summed in float32, the
folded-BN epilogue and ReLU in float32. On the card it runs
``csrc/refenc_bf16.cuh``: one clustered tensor-core launch for the stack
where it fits (``bf16_plan``), the taps' bf16 fragment tables built once
and cached (``_bf16_taps``).

``ref_encoder`` and ``gst_style_from_params`` port the JAX composition:
mask + folded-BN stack (K2), then the reference GRU (K1), then the
style-token attention. Their ``bf16=None`` resolves as
``ref_encoder_pallas`` resolves it on its accelerator (``resolve_bf16``): on
for a CUDA tensor at a shape where JAX picks the batched form
(``refenc_batched_supported`` and ``refenc_batched_vmem_ok``), off on the
CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.modules import BN_EPS, conv2d_stride2_same, mask_sequence
from .build import I, P, CudaKernel, check_cuda, ptr, refuse_grad, sm_count, stream_ptr
from .gru import gru_scan, gru_scan_plain
from .stft import mma_b_layout, round_bf16

KERNEL = CudaKernel("refenc_stack.cu", "refenc_stack_launch",
                    [P, P, P, P, P, P, I, P, P, I, I, I, I, P, P, P], branches=("bf16",))
MAX_LAYERS = 8
# a layer block's warps and output channels (csrc/refenc_stack.cu), and its
# (k parts, pixels a thread) candidates in order of preference: fewer split
# sums first, then more pixels a thread
GROUPS, CHANNEL_TILE = 8, 32
_SPLITS = ((1, 4), (1, 2), (2, 2), (1, 1), (2, 1), (4, 1), (8, 1))


def layer_plan(batch: int, t: int, f: int, channels: Sequence[int],
               sms: int) -> List[Dict[str, int]]:
    """K2's float32 launch of each layer of a (batch, t, f) stack: ``ks`` k
    parts of the input-channel sum and ``px`` pixels a thread, the first of
    ``_SPLITS`` (with ks no more than C_in) whose grid gives each of ``sms``
    SMs two blocks, else the one with the most blocks; ``blocks`` its grid
    and ``shape`` (h_out, w_out, c_out)."""
    plans, h, w, c_in = [], t, f, 1
    for c in channels:
        h, w = (h + 1) // 2, (w + 1) // 2
        ctiles = -(-c // CHANNEL_TILE)
        best = None
        for ks, px in _SPLITS:
            if ks > c_in:
                continue
            blocks = batch * ctiles * -(-(h * w) // ((GROUPS // ks) * px))
            if best is None or blocks > best["blocks"]:
                best = {"ks": ks, "px": px, "blocks": blocks, "shape": (h, w, c)}
            if blocks >= 2 * sms:
                best = {"ks": ks, "px": px, "blocks": blocks, "shape": (h, w, c)}
                break
        plans.append(best)
        c_in = c
    return plans


# the bf16 kernel (csrc/refenc_bf16.cuh): a block's shared memory, its warps,
# the partial-sum slots of its k parts (8 x 16 pixels x 32 channels), the
# widest cluster (portable), and the output rows a band aims at
_MAX_SMEM = 232448
BF16_WARPS, BF16_RED_BYTES, BF16_MAX_CLUSTER, BF16_BAND_ROWS = 8, 8 * 16 * 32 * 4, 8, 16


def _pad16(c: int) -> int:
    return -(-c // 16) * 16


def stack_shapes(t: int, f: int, channels: Sequence[int]) -> List[Dict[str, int]]:
    """Each layer's input (hi, wi, ci) and output (ho, wo, co) of a (t, f)
    stack, with the bf16 kernel's channels padded to 16 (cip, cop)."""
    out, h, w, c_in = [], t, f, 1
    for c in channels:
        ho, wo = (h + 1) // 2, (w + 1) // 2
        out.append({"hi": h, "wi": w, "ci": c_in, "cip": _pad16(c_in), "ho": ho, "wo": wo,
                    "co": c, "cop": _pad16(c)})
        h, w, c_in = ho, wo, c
    return out


def bf16_k_parts(pixels: int, cop: int, cip: int) -> int:
    """k parts of a bf16 layer whose band has ``pixels`` outputs: 1 where it
    has 8 units (16 pixels x 32 channels) or more for the 8 warps, else
    enough for 8 items, at most one a k16 step."""
    units = -(-pixels // 16) * -(-cop // 32)
    return 1 if units >= BF16_WARPS else max(1, min(9 * cip // 16, BF16_WARPS // units))


def _bf16_smem(shapes: List[Dict[str, int]], l0: int, l1: int, bh: Sequence[int]) -> Dict[str, int]:
    """Shared memory of a bf16 launch of layers [l0, l1) with ``bh`` output
    rows a band (indexed by layer): the staged input rows of its widest
    layer (layer 0 as float32, the others bf16 with 16 bytes of padding a
    pixel, a zero pixel each side), with the k parts' partial sums inside
    that region past the rows of every layer that splits its taps, then two
    ping-pong band outputs (the last layer's goes to device memory). At the
    main shape 106 KB: two CTAs an SM."""
    r16 = lambda x: -(-x // 16) * 16
    stage, red, part = 0, -1, [0, 0]
    for l in range(l0, l1):
        s, rows = shapes[l], 2 * bh[l] + 1
        need = r16(rows * (s["wi"] + 2) * (4 if l == 0 else 2 * (s["cip"] + 8)))
        stage = max(stage, need)
        if l > 0 and bf16_k_parts(bh[l] * s["wo"], s["cop"], s["cip"]) > 1:
            red = max(red, need)
        if l < l1 - 1:
            part[l % 2] = max(part[l % 2], bh[l] * s["wo"] * s["cop"] * 2)
    offs = {"stage_off": 0, "red_off": max(red, 0),
            "part_off0": stage if red < 0 else max(stage, red + BF16_RED_BYTES)}
    offs["part_off1"] = offs["part_off0"] + r16(part[0])
    offs["smem"] = offs["part_off1"] + r16(part[1])
    return offs


def bf16_plan(t: int, f: int, channels: Sequence[int]) -> Dict[str, object]:
    """The bf16 kernel's launches for a (t, f) stack, by shape alone (never
    by batch, so a row's bits do not depend on it): the stack in one launch,
    a cluster of ``cw`` CTAs an utterance each owning ceil(h / cw) output
    rows of every layer (cw the power of two nearest 16 rows a CTA of layer
    0, widened up to 8 until the CTA's shared memory fits); where it fits at
    no width, the leading layer runs alone, over bands of up to 16 rows with
    no cluster, and the rest is planned again. Returns ``launches`` (l0, l1,
    bands, smem and offsets each), each layer's band rows ``bh`` and k
    parts ``ks``."""
    shapes = stack_shapes(t, f, channels)
    n = len(shapes)
    bh, ks, launches, l0 = [0] * n, [0] * n, [], 0

    def add(l_end, bands, rows):
        for l in range(l0, l_end):
            bh[l] = rows[l]
            s = shapes[l]
            ks[l] = 1 if l == 0 else bf16_k_parts(rows[l] * s["wo"], s["cop"], s["cip"])
        launches.append({"l0": l0, "l1": l_end, "bands": bands,
                         **_bf16_smem(shapes, l0, l_end, rows)})

    while l0 < n:
        cw = 1
        while cw < min(BF16_MAX_CLUSTER, -(-shapes[l0]["ho"] // BF16_BAND_ROWS)):
            cw *= 2
        if n - l0 > 1:
            while cw <= BF16_MAX_CLUSTER:
                rows = [0] * l0 + [-(-s["ho"] // cw) for s in shapes[l0:]]
                if _bf16_smem(shapes, l0, n, rows)["smem"] <= _MAX_SMEM:
                    add(n, cw, rows)
                    return {"launches": launches, "bh": bh, "ks": ks}
                cw *= 2
        rows = [0] * n
        rows[l0] = min(shapes[l0]["ho"], BF16_BAND_ROWS)
        while _bf16_smem(shapes, l0, l0 + 1, rows)["smem"] > _MAX_SMEM:
            if rows[l0] == 1:
                raise ValueError(f"refenc_stack: layer {l0} of a (T={t}, F={f}) stack does not "
                                 "fit one block's shared memory in the bf16 mode")
            rows[l0] = (rows[l0] + 1) // 2
        add(l0 + 1, -(-shapes[l0]["ho"] // rows[l0]), rows)
        l0 += 1
    return {"launches": launches, "bh": bh, "ks": ks}


def bf16_plan_ints(plan: Dict[str, object]) -> List[int]:
    """``bf16_plan`` as the launcher's host ints: the count, then per launch
    l0, l1, bands, smem and the four offsets, then per layer bh and ks."""
    out = [len(plan["launches"])]
    for q in plan["launches"]:
        out += [q["l0"], q["l1"], q["bands"], q["smem"], q["stage_off"], q["part_off0"],
                q["part_off1"], q["red_off"]]
    for rows, k in zip(plan["bh"], plan["ks"]):
        out += [rows, k]
    return out


@functools.lru_cache(maxsize=16)
def _bf16_launch_args(t: int, f: int, channels: Tuple[int, ...]):
    """(the plan's host C int array, the largest activation but the last in
    floats a batch row, or 0 when the stack is one launch) for a (t, f)
    stack, built once a shape."""
    plan = bf16_plan(t, f, channels)
    ints = bf16_plan_ints(plan)
    act = 0
    if len(plan["launches"]) > 1:   # two bf16 activations of the leading launches
        act = max(s["ho"] * s["wo"] * s["cop"] for s in stack_shapes(t, f, channels)[:-1])
    return (ctypes.c_int * len(ints))(*ints), act


def bf16_tap_tables(conv_kernels: Sequence[torch.Tensor]) -> torch.Tensor:
    """The bf16 kernel's B fragment tables of layers 1.., flat int32 in
    layer order: each (3, 3, C_in, C_out) kernel with its channels padded to
    16 (zeros) as the (9 * cip, cop) product's ``mma_b_layout``. Layer 0
    (C_in = 1) runs on the CUDA cores from the float32 taps."""
    tables = []
    for k in conv_kernels[1:]:
        _, _, ci, co = k.shape
        kp = torch.zeros(3, 3, _pad16(ci), _pad16(co), dtype=torch.float32, device=k.device)
        kp[:, :, :ci, :co] = k.to(torch.float32)
        tables.append(mma_b_layout(kp.reshape(9 * _pad16(ci), _pad16(co))).reshape(-1))
    if not tables:
        return torch.zeros(1, dtype=torch.int32, device=conv_kernels[0].device)
    return torch.cat(tables)


_TAPS_CACHE: Dict[tuple, Tuple[Tuple[torch.Tensor, ...], torch.Tensor]] = {}


def _bf16_taps(conv_kernels: Sequence[torch.Tensor]) -> torch.Tensor:
    """``bf16_tap_tables`` of these kernels, built at their first bf16 call
    and kept (a few stacks at a time) while the kernels are unchanged: the
    key holds each kernel's storage and version counter, and the entry keeps
    the kernels alive so no other tensor takes their storage."""
    key = tuple((k.data_ptr(), k._version, tuple(k.shape), k.dtype, str(k.device))
                for k in conv_kernels)
    hit = _TAPS_CACHE.get(key)
    if hit is None:
        if len(_TAPS_CACHE) >= 8:
            _TAPS_CACHE.pop(next(iter(_TAPS_CACHE)))
        hit = _TAPS_CACHE[key] = (tuple(conv_kernels), bf16_tap_tables(conv_kernels))
    return hit[1]


def refenc_batched_supported(t: int, n_layers: int) -> bool:
    """Whether the batched Pallas form takes T (``refenc_pallas.py``'s
    rule): every intermediate height even."""
    return t % (1 << n_layers) == 0


_BATCHED_VMEM_LIMIT = 100 * 1024 * 1024   # the batched Pallas form's scoped VMEM


def refenc_batched_vmem_ok(b: int, t: int, f: int, channels: Sequence[int]) -> bool:
    """Whether the batched Pallas form's VMEM peak fits its limit, the rule by
    which ``ref_encoder_pallas`` picks that form (the shape arithmetic of
    ``refenc_pallas.py::_refenc_layout`` and ``refenc_batched_vmem_ok``): all
    phase matrices live, plus the largest layer's padded input and output."""
    n = len(channels)
    if t % (1 << n):
        raise ValueError(f"refenc_batched_vmem_ok: t {t} is not a multiple of {1 << n}")
    w, hp, c_in, wp_in = f, t + (1 << n), 1, f + 1
    mats = peak = 0
    for li, c_out in enumerate(channels):
        w = (w + 1) // 2
        wp_out = w if li == n - 1 else w + 1
        lanes_in, lanes_out = wp_in * c_in, wp_out * c_out
        mats += 3 * lanes_in * lanes_out + 2 * lanes_out
        x_in = (b * hp + 8) * lanes_in * 2          # x + its padded copy
        x_out = b * (hp // 2) * lanes_out * 2       # the sum + the masked result
        peak = max(peak, x_in + x_out)
        hp, c_in, wp_in = hp // 2, c_out, wp_out
    return 4 * (mats + peak) < _BATCHED_VMEM_LIMIT * 0.9


def resolve_bf16(bf16: Optional[bool], ref_mel: torch.Tensor,
                 channels: Sequence[int]) -> bool:
    """``bf16`` as given, or (None) as ``ref_encoder_pallas`` resolves it on
    its accelerator: on for a CUDA tensor where the batched form is chosen,
    off on the CPU (where JAX runs in interpret mode, in float32)."""
    if bf16 is not None:
        return bool(bf16)
    b, t, f = ref_mel.shape
    return (ref_mel.device.type == "cuda" and refenc_batched_supported(t, len(channels))
            and refenc_batched_vmem_ok(b, t, f, channels))


def fold_bn(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = BN_EPS
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm -> (scale, bias) epilogue, Keras eps convention."""
    inv = scale / torch.sqrt(var + eps)
    return inv, bias - mean * inv


def refenc_stack_plain(ref_mel: torch.Tensor, conv_kernels: Sequence[torch.Tensor],
                       bn_scales: Sequence[torch.Tensor],
                       bn_biases: Sequence[torch.Tensor], *,
                       lengths: Optional[torch.Tensor] = None,
                       bf16: bool = False) -> torch.Tensor:
    """The same stack in plain PyTorch (patch slices + one product a layer);
    ``bf16`` rounds each layer's input and kernel to bfloat16 first (their
    products are exact in float32, so the float32 sums compute the bf16
    mode's function)."""
    x = mask_sequence(ref_mel, lengths)[..., None]            # (B, T, F, 1)
    for kern, sc, bi in zip(conv_kernels, bn_scales, bn_biases):
        if bf16:
            x, kern = round_bf16(x), round_bf16(kern)
        x = torch.relu(conv2d_stride2_same(x, kern) * sc + bi)
    b, t, f, c = x.shape
    return x.reshape(b, t, f * c)


def refenc_stack(ref_mel: torch.Tensor, conv_kernels: Sequence[torch.Tensor],
                 bn_scales: Sequence[torch.Tensor],
                 bn_biases: Sequence[torch.Tensor], *,
                 lengths: Optional[torch.Tensor] = None,
                 bf16: bool = False) -> torch.Tensor:
    """Conv stack: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; ``bf16`` the bf16 operand mode (counted as the kernel's
    ``bf16`` branch)."""
    if ref_mel.device.type == "cpu":
        return refenc_stack_plain(ref_mel, conv_kernels, bn_scales, bn_biases,
                                  lengths=lengths, bf16=bf16)
    refuse_grad("refenc_stack", ref_mel, *conv_kernels, *bn_scales, *bn_biases)
    b, t, f = ref_mel.shape
    channels = [int(k.shape[-1]) for k in conv_kernels]
    if not 1 <= len(channels) <= MAX_LAYERS:
        raise ValueError(f"refenc_stack: {len(channels)} layers, kernel takes 1..{MAX_LAYERS}")
    c_in = 1
    for k, c in zip(conv_kernels, channels):
        if tuple(k.shape) != (3, 3, c_in, c):
            raise ValueError(f"refenc_stack: kernel shape {tuple(k.shape)}")
        c_in = c
    params = torch.cat([torch.cat([k.reshape(-1), s.reshape(-1), bb.reshape(-1)])
                        for k, s, bb in zip(conv_kernels, bn_scales, bn_biases)]
                       ).to(torch.float32).contiguous()
    mel = ref_mel.to(torch.float32).contiguous()
    lens = None if lengths is None else lengths.to(mel.device, torch.int32).contiguous()
    check_cuda("refenc_stack", mel, params, lens)
    h, w = t, f
    for _ in channels:
        h, w = (h + 1) // 2, (w + 1) // 2
    out = torch.empty(b, h, w * channels[-1], device=mel.device, dtype=torch.float32)
    if b == 0:
        return out
    if b > 65535:
        raise ValueError(f"refenc_stack: batch {b} > 65535")
    host = lambda xs: (ctypes.c_int * len(xs))(*xs)      # read on the host
    if bf16:
        plan_arg, act = _bf16_launch_args(t, f, tuple(channels))
        taps = _bf16_taps(conv_kernels)
        # two bf16 activations (b * act floats) where the leading layers run alone
        scratch = torch.empty(b * act, device=mel.device, dtype=torch.float32) if act else None
        check_cuda("refenc_stack", taps, scratch)
        KERNEL(ptr(mel), ptr(lens), ptr(params), host(channels), None, None, len(channels),
               ptr(out), ptr(scratch), b, t, f, 1, plan_arg, ptr(taps), stream_ptr(mel.device),
               branch="bf16")
        return out
    plan = layer_plan(b, t, f, channels, sm_count(mel.device.index))
    # the ping-pong scratch of every activation but the last
    max_act = max([1] + [int(np.prod(p["shape"])) for p in plan[:-1]])
    scratch = torch.empty(2, b, max_act, device=mel.device, dtype=torch.float32)
    KERNEL(ptr(mel), ptr(lens), ptr(params), host(channels), host([p["ks"] for p in plan]),
           host([p["px"] for p in plan]), len(channels), ptr(out), ptr(scratch), b, t, f,
           0, None, None, stream_ptr(mel.device))
    return out


def ref_encoder(enc, ref_mel: torch.Tensor, mel_lengths: Optional[torch.Tensor],
                *, plain: bool = False, bf16: Optional[bool] = None) -> torch.Tensor:
    """ReferenceEncoder forward from its parameters (inference): masked,
    folded-BN conv stack (K2), then the GRU (K1) -> (B, ref_gru_dim).
    ``enc`` is a ``models.gst.ReferenceEncoder``; ``plain`` runs the plain
    versions of both kernels whatever the device; ``bf16`` the stack's bf16
    operand mode (None: ``resolve_bf16``)."""
    n_layers = len(enc.cfg.ref_conv_channels)
    kernels, scales, biases = [], [], []
    for i in range(n_layers):
        bn = getattr(enc, f"bn_{i}")
        sc, bi = fold_bn(bn.scale, bn.bias, bn.mean, bn.var)
        kernels.append(getattr(enc, f"conv_{i}").kernel)
        scales.append(sc)
        biases.append(bi)
    bf16 = resolve_bf16(bf16, ref_mel, enc.cfg.ref_conv_channels)
    stack = refenc_stack_plain if plain else refenc_stack
    feats = stack(ref_mel, kernels, scales, biases, lengths=mel_lengths, bf16=bf16)
    stride_total = 2 ** n_layers
    gru_lengths = None
    if mel_lengths is not None:
        gru_lengths = torch.clamp((mel_lengths + stride_total - 1) // stride_total, min=1)
    g = enc.gru
    scan = gru_scan_plain if plain else gru_scan
    h0 = torch.zeros(feats.shape[0], g.features, device=feats.device)
    _, final = scan(feats, h0, g.kernel, g.bias, g.recurrent_kernel,
                    g.recurrent_bias, lengths=gru_lengths)
    return final


def style_attention(stl, ref: torch.Tensor,
                    token_weights: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.float32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Style-token multi-head attention of ``ref`` (B, D) over the tanh
    tokens; ``token_weights`` (B, N) replaces the attention distribution.
    ``stl`` is a ``models.gst.StyleTokenLayer``. The projections and the
    scores' product run in ``dtype``; the scores are then divided in float32
    (at least), as the JAX layer's numpy-scalar division promotes them, so
    the attention and the style are float32 there too."""
    c = stl.cfg
    head_dim = c.style_dim // c.num_heads
    wide = torch.promote_types(dtype, torch.float32)
    keys_base = torch.tanh(stl.tokens).to(dtype)
    q = ref.to(dtype) @ stl.query_proj.kernel.to(dtype)
    k = keys_base @ stl.key_proj.kernel.to(dtype)
    v = keys_base @ stl.value_proj.kernel.to(dtype)
    b = q.shape[0]
    q = q.reshape(b, c.num_heads, head_dim)
    k = k.reshape(c.num_tokens, c.num_heads, head_dim)
    v = v.reshape(c.num_tokens, c.num_heads, head_dim)
    scores = torch.einsum("bhd,nhd->bhn", q, k).to(wide) / np.sqrt(head_dim)
    e = torch.exp(scores - scores.max(-1, keepdim=True).values)
    attn = e / e.sum(-1, keepdim=True)                        # jax.nn.softmax
    if token_weights is not None:
        attn = token_weights[:, None, :].to(attn.dtype).expand_as(attn)
    style = torch.einsum("bhn,nhd->bhd", attn, v.to(wide)).reshape(b, c.style_dim)
    return style, attn


def gst_style_from_params(gst, ref_mel: Optional[torch.Tensor],
                          mel_lengths: Optional[torch.Tensor] = None,
                          token_weights: Optional[torch.Tensor] = None, *,
                          plain: bool = False, bf16: Optional[bool] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full GST block (inference): reference encoder (K2 + K1) and the
    style-token attention. ``gst`` is a ``models.gst.GST``; with no
    reference mel the style comes from ``token_weights`` alone. ``bf16``
    as ``ref_encoder``'s: the JAX fast path leaves it to resolve."""
    c = gst.cfg
    if ref_mel is None:
        if token_weights is None:
            raise ValueError("gst_style_from_params needs ref_mel or token_weights")
        ref = torch.zeros(token_weights.shape[0], c.ref_gru_dim,
                          device=token_weights.device)
    else:
        ref = ref_encoder(gst.reference_encoder, ref_mel, mel_lengths, plain=plain, bf16=bf16)
    return style_attention(gst.stl, ref, token_weights)
