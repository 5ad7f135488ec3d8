"""Plain WaveRNN scores of sampled classes.

The vocoder's step (sample embedding of the previous mu-law class plus the
frame's conditioning, a GRU with gates z, r, n and reset after, ReLU FC,
class logits) run teacher-forced over given classes, the start class
K // 2. The scan is ``torch.nn.GRU`` with the gates reordered to its r, z, n,
which computes the same cell. Sampling adds Gumbel noise from the Philox
stream 2 to ``logits / temperature`` and takes the argmax.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import philox

_CHUNK = 4096


def _torch_gru(w: Dict[str, torch.Tensor], prefix: str) -> torch.nn.GRU:
    kern = w[f"{prefix}.kernel"]
    h = kern.shape[1] // 3
    order = lambda m: torch.cat([m[..., h:2 * h], m[..., :h], m[..., 2 * h:]], -1)
    g = torch.nn.GRU(kern.shape[0], h, batch_first=True).to(kern.device)
    with torch.no_grad():
        g.weight_ih_l0.copy_(order(kern).T)
        g.weight_hh_l0.copy_(order(w[f"{prefix}.recurrent_kernel"]).T)
        g.bias_ih_l0.copy_(order(w[f"{prefix}.bias"]))
        g.bias_hh_l0.copy_(order(w[f"{prefix}.recurrent_bias"]))
    return g


@torch.no_grad()
def scores(w: Dict[str, torch.Tensor], mel: torch.Tensor, classes: torch.Tensor, *,
           hop: int, seed: int, rows: Sequence[int], temperature: float = 1.0):
    """Yields (sample offset, scores (len(rows), n, K)) chunk by chunk: each
    sample's noisy class scores given the classes before it. ``mel`` (B, T, M)
    and ``classes`` (B, T * hop) are the call's; ``rows`` the rows to score
    (the noise is drawn for their global indices)."""
    rows = list(rows)
    k = w["sample_embed.embedding"].shape[0]
    cond = mel[rows] @ w["cond_proj.kernel"] + w["cond_proj.bias"]
    cls = classes[rows].to(torch.int64)
    b, n = cls.shape
    prev = torch.cat([torch.full((b, 1), k // 2, dtype=torch.int64, device=cls.device),
                      cls[:, :-1]], 1)
    x = w["sample_embed.embedding"][prev] + torch.repeat_interleave(cond, hop, dim=1)
    g, h, parts = _torch_gru(w, "gru"), None, []
    for s0 in range(0, n, _CHUNK):          # cuDNN takes sequences in pieces
        y, h = g(x[:, s0: s0 + _CHUNK].contiguous(), h)
        parts.append(y)
    del x
    ys = torch.cat(parts, 1)
    for s0 in range(0, n, _CHUNK):
        y = ys[:, s0: s0 + _CHUNK]
        logits = torch.relu(y @ w["fc1.kernel"] + w["fc1.bias"]) @ w["fc2.kernel"] + w["fc2.bias"]
        steps = torch.arange(s0, s0 + y.shape[1], device=cls.device)
        noise = torch.stack([philox.uniforms(seed, steps, philox.STREAM_GUMBEL, 1, k, row0=r)[:, 0]
                             for r in rows], 0)
        yield s0, logits / temperature - torch.log(-torch.log(noise))


def first_choices(w, mel, classes, *, hop: int, seed: int, rows: Sequence[int],
                  temperature: float = 1.0) -> torch.Tensor:
    """(len(rows), n): the class each step's scores put first, scored on
    the given ``classes`` before it."""
    return torch.cat([sc.argmax(-1) for _, sc in scores(
        w, mel, classes, hop=hop, seed=seed, rows=rows, temperature=temperature)], 1)


def widest_gap(w, mel, classes, *, hop: int, seed: int, rows: Sequence[int],
               temperature: float = 1.0, picks=None) -> float:
    """How far a chosen class of any sample of ``rows`` scores below the
    best class of its step, scored on the given ``classes`` before it: the
    chosen class is the given one, or ``picks`` (len(rows), n) where given
    (another scorer's first choices, for a control)."""
    worst = 0.0
    chosen_all = classes[list(rows)].to(torch.int64) if picks is None else picks
    for s0, sc in scores(w, mel, classes, hop=hop, seed=seed, rows=rows,
                         temperature=temperature):
        pick = chosen_all[:, s0: s0 + sc.shape[1]]
        chosen = sc.gather(-1, pick[..., None])[..., 0]
        worst = max(worst, float((sc.max(-1).values - chosen).max()))
    return worst


def mulaw_classes(wav: np.ndarray, bits: int) -> np.ndarray:
    """The mu-law class of each sample of a decoded waveform in [-1, 1]."""
    mu = 2 ** bits - 1
    y = np.sign(wav) * np.log1p(mu * np.abs(wav)) / np.log1p(mu)
    return np.clip(np.rint((y + 1.0) / 2.0 * mu), 0, mu).astype(np.int64)
