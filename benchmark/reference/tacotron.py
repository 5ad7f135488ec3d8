"""Plain GST-Tacotron synthesis from a configuration dict and a weights dict.

A frozen copy of the model's inference math in plain torch, one operation
at a time, with no kernel: the text front end, the Taco1 encoder (prenet
with dropout, CBHG), the GST reference encoder (3x3 stride-2 convs, folded
BatchNorm, GRU) and style-token attention, the Bahdanau or
location-sensitive decoder (its prenet dropout drawn from the Philox
streams), the post-net CBHG. Weights are keyed by the model's state-dict
names (the flax layout: kernels (in, out), GRU gates z, r, n with reset
after, BatchNorm eps 1e-3).

The encoder's prenet dropout is drawn, as the model draws it, from a torch
generator on the device seeded with the call's seed (the first layer's
mask, then the second's); the decoder's from the Philox streams 0 and 1
under the seed plus one.

``decode`` takes the frames it is fed: the program's own decoded frames
when judging them (each step is then compared with what the program made
of the same input), or, with none given, its own previous frame.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import philox

W = Dict[str, torch.Tensor]

BN_EPS = 1e-3
_PUNCTUATION = "!'(),-.:;? "
_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
SYMBOLS = ["_", "~"] + list(_PUNCTUATION) + list(_LETTERS) + list("0123456789")
_IDS = {s: i for i, s in enumerate(SYMBOLS)}
EOS_ID = 1


def text_ids(texts: Sequence[str], pad_multiple: int) -> Tuple[np.ndarray, np.ndarray]:
    """Lowercased, whitespace-collapsed texts of letters and spaces -> ids
    with EOS, padded with 0 to a multiple of ``pad_multiple``, and lengths.
    Digits, abbreviations and non-ASCII text take cleaning steps this copy
    does not hold, so it refuses them."""
    seqs = []
    for t in texts:
        clean = " ".join(t.lower().split())
        if any(c not in " abcdefghijklmnopqrstuvwxyz" for c in clean):
            raise ValueError(f"reference front end: only letters and spaces, got {t!r}")
        seqs.append([_IDS[c] for c in clean] + [EOS_ID])
    lengths = np.array([len(s) for s in seqs], np.int64)
    width = -(-int(lengths.max()) // pad_multiple) * pad_multiple
    ids = np.zeros((len(seqs), width), np.int64)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
    return ids, lengths


def mask(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    if lengths is None:
        return x
    valid = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
    return x * valid[..., None].to(x.dtype)


def dense(w: W, name: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    y = x @ w[f"{name}.kernel"]
    return y + w[f"{name}.bias"] if bias else y


def batchnorm(w: W, name: str, x: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm with the running statistics."""
    mul = torch.rsqrt(w[f"{name}.var"] + BN_EPS) * w[f"{name}.scale"]
    return (x - w[f"{name}.mean"]) * mul + w[f"{name}.bias"]


def gru_update(gx: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    xz, xr, xn = gx.chunk(3, dim=-1)
    hz, hr, hn = gh.chunk(3, dim=-1)
    z = torch.sigmoid(xz + hz)
    r = torch.sigmoid(xr + hr)
    n = torch.tanh(xn + r * hn)
    return z * h + (1.0 - z) * n


def gru(w: W, name: str, xs: torch.Tensor, lengths: Optional[torch.Tensor] = None,
        reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked GRU scan: a step at or past a row's length holds the state."""
    b, t, _ = xs.shape
    gx = xs @ w[f"{name}.kernel"] + w[f"{name}.bias"]
    wh, bh = w[f"{name}.recurrent_kernel"], w[f"{name}.recurrent_bias"]
    h = xs.new_zeros(b, wh.shape[0])
    valid = (torch.ones(b, t, dtype=torch.bool, device=xs.device) if lengths is None
             else torch.arange(t, device=xs.device)[None, :] < lengths[:, None])
    ys = [None] * t
    for i in (range(t - 1, -1, -1) if reverse else range(t)):
        h = torch.where(valid[:, i, None], gru_update(gx[:, i], h @ wh + bh, h), h)
        ys[i] = h
    return torch.stack(ys, 1), h


def prenet(w: W, name: str, x: torch.Tensor, layers: int, rate: float,
           gen: Optional[torch.Generator]) -> torch.Tensor:
    for i in range(layers):
        x = torch.relu(dense(w, f"{name}.dense_{i}", x))
        if gen is not None:
            keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
            x = torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
    return x


def conv1d_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME 1-D conv with a (k, in, out) kernel, (k-1)//2 left, k//2 right."""
    k, t = kernel.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, (k - 1) // 2, k // 2))
    return torch.cat([xp[:, j: j + t] for j in range(k)], -1) @ kernel.reshape(-1, kernel.shape[-1])


def bank_tap_mask(bank_k: int, c_in: int, channels: int, device) -> torch.Tensor:
    """Live blocks of the conv bank's (shifts * C_in, K * C_out) matrix:
    block (shift s, width k) is live iff 0 <= s + (k-1)//2 < k."""
    smin, smax = -((bank_k - 1) // 2), bank_k // 2
    m = np.zeros((smax - smin + 1, c_in, bank_k, channels), np.float32)
    for si, s in enumerate(range(smin, smax + 1)):
        for k in range(1, bank_k + 1):
            if 0 <= s + (k - 1) // 2 < k:
                m[si, :, k - 1, :] = 1.0
    return torch.from_numpy(m.reshape(-1, bank_k * channels)).to(device)


def cbhg(w: W, name: str, x: torch.Tensor, lengths: Optional[torch.Tensor], c: dict,
         norm=None) -> torch.Tensor:
    """Conv bank (widths 1..K, BN, ReLU) -> maxpool 2/1 -> conv projections
    (BN; ReLU but the last) -> residual -> highways -> BiGRU. ``norm(name,
    x)`` is the BatchNorm (the running statistics' by default)."""
    norm = norm or (lambda n, y: batchnorm(w, n, y))
    residual = x
    k = c["cbhg_bank_k"]
    y = mask(x, lengths)
    t, c_in = y.shape[1], y.shape[2]
    smin, smax = -((k - 1) // 2), k // 2
    yp = F.pad(y, (0, 0, -smin, smax))
    taps = torch.cat([yp[:, s - smin: s - smin + t] for s in range(smin, smax + 1)], -1)
    bank = w[f"{name}.bank.bank_kernel"] * bank_tap_mask(k, c_in, c["cbhg_bank_channels"],
                                                         x.device)
    y = torch.relu(norm(f"{name}.bank.bn", taps @ bank))
    y = mask(y, lengths)
    padded = F.pad(y, (0, 0, 0, 1), value=-float("inf"))
    y = torch.maximum(padded[:, :-1], padded[:, 1:])
    n_proj = len(c["cbhg_proj_channels"])
    for i in range(n_proj):
        y = norm(f"{name}.proj_bn_{i}",
                 conv1d_same(mask(y, lengths), w[f"{name}.proj_{i}.kernel"]))
        if i + 1 < n_proj:
            y = torch.relu(y)
    if f"{name}.residual_proj.kernel" in w:
        residual = dense(w, f"{name}.residual_proj", residual)
    y = y + residual
    if f"{name}.pre_highway.kernel" in w:
        y = dense(w, f"{name}.pre_highway", y)
    for i in range(c["cbhg_highway_layers"]):
        h = torch.relu(dense(w, f"{name}.highway_{i}.h", y))
        g = torch.sigmoid(dense(w, f"{name}.highway_{i}.t", y))
        y = h * g + y * (1.0 - g)
    y = mask(y, lengths)
    fwd, _ = gru(w, f"{name}.bigru.fwd", y, lengths)
    bwd, _ = gru(w, f"{name}.bigru.bwd", y, lengths, reverse=True)
    return torch.cat([fwd, bwd], -1)


def conv2d_stride2_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 TF-SAME conv of NHWC ``x`` with a (3, 3, in, out) kernel."""
    _, h, wd, c = x.shape
    ho, wo = (h + 1) // 2, (wd + 1) // 2
    ph, pw = max(0, (ho - 1) * 2 + 3 - h), max(0, (wo - 1) * 2 + 3 - wd)
    xp = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    patches = [xp[:, i: i + 2 * ho: 2, j: j + 2 * wo: 2, :] for i in range(3) for j in range(3)]
    return torch.cat(patches, -1) @ kernel.reshape(9 * c, kernel.shape[-1])


def gst_style(w: W, ref_mel: torch.Tensor, lengths: torch.Tensor, g: dict,
              bf16: bool) -> torch.Tensor:
    """Reference encoder (masked mel, n x [conv, folded BN, ReLU], GRU over
    ceil(len / 2^n) steps) and the multi-head style attention over the tanh
    tokens -> style (B, style_dim). ``bf16`` rounds each conv's input and
    kernel to bfloat16 (float32 sums)."""
    from .dsp import round_bf16

    n = len(g["ref_conv_channels"])
    x = mask(ref_mel, lengths)[..., None]
    for i in range(n):
        p = f"gst.reference_encoder.bn_{i}"
        scale = w[f"{p}.scale"] / torch.sqrt(w[f"{p}.var"] + BN_EPS)
        shift = w[f"{p}.bias"] - w[f"{p}.mean"] * scale
        kern = w[f"gst.reference_encoder.conv_{i}.kernel"]
        if bf16:
            x, kern = round_bf16(x), round_bf16(kern)
        x = torch.relu(conv2d_stride2_same(x, kern) * scale + shift)
    b, t, f, c = x.shape
    steps = torch.clamp((lengths + 2 ** n - 1) // 2 ** n, min=1)
    _, ref = gru(w, "gst.reference_encoder.gru", x.reshape(b, t, f * c), steps)
    heads, dim = g["num_heads"], g["style_dim"] // g["num_heads"]
    keys_base = torch.tanh(w["gst.stl.tokens"])
    q = (ref @ w["gst.stl.query_proj.kernel"]).reshape(b, heads, dim)
    k = (keys_base @ w["gst.stl.key_proj.kernel"]).reshape(-1, heads, dim)
    v = (keys_base @ w["gst.stl.value_proj.kernel"]).reshape(-1, heads, dim)
    attn = torch.softmax(torch.einsum("bhd,nhd->bhn", q, k) / np.sqrt(dim), -1)
    return torch.einsum("bhn,nhd->bhd", attn, v).reshape(b, g["style_dim"])


def encoder(w: W, tokens: torch.Tensor, lengths: torch.Tensor, e: dict,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    x = w["encoder.embedding.embedding"][tokens]
    x = prenet(w, "encoder.prenet", x, len(e["prenet_dims"]), e["prenet_dropout"], gen)
    return mask(cbhg(w, "encoder.cbhg", x, lengths, e), lengths)


def decode(w: W, memory: torch.Tensor, lengths: torch.Tensor, m: dict, steps: int,
           seed: Optional[int], fed: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The AR decoder over ``memory`` (B, T, M) -> (mel (B, steps * r, M),
    stop logits (B, steps * r), alignments (B, steps, T)). Step s is fed the
    last frame of step s - 1 of ``fed`` (B, steps * r, M) where given, else
    of its own output; the go frame is zeros. ``seed`` None: no dropout."""
    d, a = m["decoder"], m["attention"]
    r, nm = d["reduction_factor"], m["num_mels"]
    rate = d["prenet_dropout"]
    p = "decoder.cell"
    b, t, _ = memory.shape
    dev = memory.device
    keys = memory @ w[f"{p}.attention.memory_proj.kernel"]
    vvec = w[f"{p}.attention.score_v.kernel"][:, 0]
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    valid[:, 0] = True
    loc = a["kind"] == "location_sensitive"
    if loc:
        lk = w[f"{p}.attention.location_conv.kernel"]
        loca = lk.reshape(-1, lk.shape[-1]) @ w[f"{p}.attention.location_proj.kernel"]
        taps, chans = a["location_kernel_size"], 2 if a["cumulative"] else 1
    keep = None
    if seed is not None:
        idx = torch.arange(steps, device=dev)
        keep = [philox.uniforms(seed, idx, layer, b, w[f"{p}.prenet.dense_{layer}.kernel"]
                                .shape[1]) >= rate for layer in (0, 1)]

    def cell(name, x, h):
        return gru_update(x @ w[f"{name}.kernel"] + w[f"{name}.bias"],
                          h @ w[f"{name}.recurrent_kernel"] + w[f"{name}.recurrent_bias"], h)

    zeros = lambda n: memory.new_zeros(b, n)
    h_attn, h1, h2 = zeros(d["attention_rnn_dim"]), zeros(d["decoder_rnn_dim"]), \
        zeros(d["decoder_rnn_dim"])
    ctx, prev, cum = zeros(memory.shape[2]), zeros(t), zeros(t)
    prev[:, 0] = 1.0
    frame = zeros(nm)
    mels, stops, aligns = [], [], []
    for s in range(steps):
        x = torch.relu(frame @ w[f"{p}.prenet.dense_0.kernel"] + w[f"{p}.prenet.dense_0.bias"])
        if keep is not None:
            x = torch.where(keep[0][s], x / (1.0 - rate), torch.zeros_like(x))
        x = torch.relu(x @ w[f"{p}.prenet.dense_1.kernel"] + w[f"{p}.prenet.dense_1.bias"])
        if keep is not None:
            x = torch.where(keep[1][s], x / (1.0 - rate), torch.zeros_like(x))
        h_attn = cell(f"{p}.attention_rnn", torch.cat([x, ctx], -1), h_attn)
        arg = keys + (h_attn @ w[f"{p}.attention.query_proj.kernel"])[:, None, :]
        if loc:
            feats = torch.stack([prev, cum][:chans], -1)
            fp = F.pad(feats, (0, 0, (taps - 1) // 2, taps // 2))
            arg = arg + torch.cat([fp[:, j: j + t] for j in range(taps)], -1) @ loca
        scores = torch.where(valid, torch.tanh(arg) @ vvec, torch.full((b, t), -1e9, device=dev))
        e = torch.exp(scores - scores.max(-1, keepdim=True).values) * valid
        align = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-9)
        ctx = torch.einsum("bt,btm->bm", align, memory)
        prev, cum = align, cum + align
        h = torch.cat([h_attn, ctx], -1) @ w[f"{p}.decoder_input_proj.kernel"] \
            + w[f"{p}.decoder_input_proj.bias"]
        h1 = cell(f"{p}.decoder_rnn_0", h, h1)
        h = h + h1
        h2 = cell(f"{p}.decoder_rnn_1", h, h2)
        h = h + h2
        out = torch.cat([h, ctx], -1)
        frames = dense(w, f"{p}.frame_proj", out)
        mels.append(frames.reshape(b, r, nm))
        stops.append(dense(w, f"{p}.stop_proj", out))
        aligns.append(align)
        frame = (frames[:, (r - 1) * nm:] if fed is None
                 else fed[:, (s + 1) * r - 1])
    return (torch.cat(mels, 1), torch.cat(stops, 1), torch.stack(aligns, 1))


def frame_lengths(stop_logits: torch.Tensor, d: dict) -> torch.Tensor:
    """Frames up to and including the first stop, or all of them."""
    b, n = stop_logits.shape
    if not d["use_stop_token"]:
        return torch.full((b,), n, dtype=torch.int64, device=stop_logits.device)
    stopped = torch.sigmoid(stop_logits) > d["stop_threshold"]
    first = torch.argmax(stopped.to(torch.int32), 1) + 1
    return torch.where(stopped.any(1), first, torch.full_like(first, n))


def postnet(w: W, mel: torch.Tensor, lengths: torch.Tensor, m: dict) -> torch.Tensor:
    return dense(w, "postnet.linear_proj", cbhg(w, "postnet.cbhg", mel, lengths, m["postnet"]))


def synthesize(w: W, cfg: dict, texts: Sequence[str], ref_mel: torch.Tensor,
               ref_lengths: torch.Tensor, seed: int, *, fed: Optional[torch.Tensor] = None,
               ref_stack_bf16: bool = False, text_pad: int = 32) -> Dict[str, torch.Tensor]:
    """One synthesis call up to the linear spectrogram: style, memory,
    decode (fed ``fed`` where given), stop lengths, masked frames,
    post-net. Returns device tensors."""
    m = cfg["model"]
    dev = ref_mel.device
    ids, lens = text_ids(texts, text_pad)
    tokens = torch.from_numpy(ids).to(dev)
    tok_len = torch.from_numpy(lens).to(dev)
    style = gst_style(w, ref_mel, ref_lengths, m["gst"], ref_stack_bf16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    enc = encoder(w, tokens, tok_len, m["encoder"], gen)
    t = enc.shape[1]
    memory = torch.cat([enc, style[:, None, :].expand(-1, t, -1)], -1)
    steps = m["decoder"]["max_decode_steps"]
    mel, stops, aligns = decode(w, memory, tok_len, m, steps, seed + 1, fed)
    lengths = frame_lengths(stops, m["decoder"])
    mel = mask(mel, lengths)
    linear = postnet(w, mel, lengths, m)
    return {"style_embedding": style, "mel": mel, "stop_logits": stops, "alignments": aligns,
            "frame_lengths": lengths, "linear": linear}
