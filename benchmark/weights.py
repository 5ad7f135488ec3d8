"""Seeded weights for a model's state-dict names, made on the device in two
draws: one uniform draw and one normal draw, each leaf a slice of one of
them, scaled and shifted. Kernels are glorot-uniform; style tokens and
embeddings normal (0.5 and 1 / sqrt(width)); every bias normal (0.1), a
highway's transform-gate bias about -1; BatchNorm's scale uniform in
[0.75, 1.25], its shift and running mean normal (0.1), its running
variance uniform in [0.5, 2]. No term is left at a value (0, 1) that a
kernel could drop unseen. The program and the reference are both handed
these tensors; neither makes its own.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

BIAS_STD = 0.1


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    return receptive * shape[-2], receptive * shape[-1]


def _init(name: str, shape: Tuple[int, ...]) -> Tuple[str, float, float]:
    """(draw, scale, shift) of a leaf: ``uniform`` in [-1, 1) or ``normal``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("kernel", "recurrent_kernel", "bank_kernel"):
        fi, fo = _fans(shape)
        return "uniform", float(np.sqrt(6.0 / (fi + fo))), 0.0
    if leaf == "tokens":
        return "normal", 0.5, 0.0
    if leaf == "embedding":
        return "normal", float(1.0 / np.sqrt(shape[-1])), 0.0
    if leaf == "scale":
        return "uniform", 0.25, 1.0
    if leaf == "var":
        return "uniform", 0.75, 1.25
    if leaf in ("bias", "recurrent_bias", "mean"):
        return "normal", BIAS_STD, -1.0 if name.endswith(".t.bias") else 0.0
    raise KeyError(f"no initializer for {name!r}")


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    draws = {"uniform": lambda n: torch.rand(n, generator=gen, device=device) * 2 - 1,
             "normal": lambda n: torch.randn(n, generator=gen, device=device)}
    leaves = {kind: [] for kind in draws}
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        kind, scale, shift = _init(name, shape)
        leaves[kind].append((name, shape, scale, shift))
    out: Dict[str, torch.Tensor] = {}
    for kind, draw in draws.items():
        group = leaves[kind]
        if not group:
            continue
        counts = torch.tensor([int(np.prod(s)) for _, s, _, _ in group], device=device)
        per = lambda i: torch.repeat_interleave(
            torch.tensor([g[i] for g in group], device=device), counts)
        flat = draw(int(counts.sum())) * per(2) + per(3)
        for (name, shape, _, _), part in zip(group, torch.split(flat, counts.tolist())):
            out[name] = part.view(shape)
    return out
