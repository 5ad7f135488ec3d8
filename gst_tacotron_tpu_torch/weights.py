"""Weights: the JAX package's variables <-> the port's modules, and a seeded
init.

The JAX variables arrive as a flat mapping of numpy arrays keyed
``params/<flax path>`` and ``batch_stats/<flax path>`` (the layout of
``tests/fixtures/golden/params.npz``). The port's modules keep the flax names
and layouts, so a key maps onto a state-dict entry by replacing ``/`` with
``.``, with one rename: a BiGRU's ``forward``/``backward`` are ``fwd``/``bwd``
here. Layouts that carry over unchanged and that the modules honour:

  * GRU kernels (in, 3H) and (H, 3H), gate order z, r, n (``models/rnn.py``);
  * BatchNorm ``scale``/``bias`` with running ``mean``/``var``, eps 1e-3;
  * ``MatmulConv1D`` kernel (k, in, out), padded (k-1)//2 left, k//2 right;
  * the conv bank's ``bank_kernel`` block matrix, masked by its tap mask;
  * the post-net maxpool pads its right edge with -inf (in ``CBHG``);
  * the speaker embedding (``speaker_embedding/embedding``, num_speakers > 1).

``export_flat`` is the inverse of ``load_flat``: the model's parameters and
BatchNorm buffers under their flat JAX names.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .config import Config
from .device import resolve_device
from .models.modules import BatchNorm
from .models.tacotron import GSTTacotron
from .models.wavernn import WaveRNN
from .text import NUM_SYMBOLS

_RENAMES = {"forward": "fwd", "backward": "bwd"}
_INVERSE = {v: k for k, v in _RENAMES.items()}


def flat_key_to_state_key(key: str) -> str:
    collection, _, path = key.partition("/")
    if collection not in ("params", "batch_stats"):
        raise KeyError(f"unknown variable collection in {key!r}")
    return ".".join(_RENAMES.get(p, p) for p in path.split("/"))


def load_flat(model: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Copy every flat JAX variable into ``model``. Raises on a missing or
    unexpected key or a shape mismatch."""
    state = model.state_dict()
    seen = set()
    with torch.no_grad():
        for key, value in flat.items():
            sk = flat_key_to_state_key(key)
            if sk not in state:
                raise KeyError(f"{key!r} -> {sk!r} has no counterpart in the model")
            arr = torch.from_numpy(np.array(value, np.float32))
            if tuple(arr.shape) != tuple(state[sk].shape):
                raise ValueError(f"{key!r}: shape {tuple(arr.shape)} vs "
                                 f"{tuple(state[sk].shape)}")
            state[sk].copy_(arr)
            seen.add(sk)
    missing = sorted(set(state) - seen)
    if missing:
        raise KeyError(f"variables missing from the flat mapping: {missing}")


def state_key_to_flat(key: str, collection: str = "params") -> str:
    """The inverse of ``flat_key_to_state_key``."""
    return f"{collection}/" + "/".join(_INVERSE.get(p, p) for p in key.split("."))


def export_flat(model: nn.Module) -> Dict[str, np.ndarray]:
    """{flat JAX name: float32 array} of every parameter (``params/...``)
    and BatchNorm running statistic (``batch_stats/...``) of ``model``."""
    stats = {f"{name}.{b}" if name else b
             for name, mod in model.named_modules() if isinstance(mod, BatchNorm)
             for b in ("mean", "var")}
    return {state_key_to_flat(key, "batch_stats" if key in stats else "params"):
            value.detach().cpu().numpy().astype(np.float32)
            for key, value in model.state_dict().items()}


def _glorot_uniform(p: torch.Tensor, fan_in: int, fan_out: int, g: torch.Generator) -> None:
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    p.uniform_(-limit, limit, generator=g)


def _orthogonal(p: torch.Tensor, g: torch.Generator) -> None:
    rows, cols = p.shape
    a = torch.randn(max(rows, cols), min(rows, cols), generator=g, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    p.copy_((q if rows >= cols else q.T).to(p.dtype))


def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded init with the flax initializers' distributions: glorot-uniform
    kernels (the conv bank masked to its live taps), orthogonal recurrent
    kernels, zero biases (-1 for a highway's transform gate), normal(0.5)
    style tokens, fan-in normal embeddings; BatchNorm stays at identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                full = f"{name}.{pname}" if name else pname
                if pname == "recurrent_kernel":
                    _orthogonal(p, g)
                elif pname in ("kernel", "bank_kernel"):
                    shape = p.shape
                    receptive = int(np.prod(shape[:-2])) if p.dim() > 2 else 1
                    _glorot_uniform(p, receptive * shape[-2], receptive * shape[-1], g)
                    if pname == "bank_kernel":
                        p.mul_(mod.tap_mask)
                elif pname == "tokens":
                    p.normal_(0.0, 0.5, generator=g)
                elif pname == "embedding":
                    p.normal_(0.0, float(1.0 / np.sqrt(p.shape[1])), generator=g)
                elif pname == "scale":
                    p.fill_(1.0)
                elif pname in ("bias", "recurrent_bias"):
                    p.fill_(-1.0 if full.endswith(".t.bias") else 0.0)
                else:
                    raise KeyError(f"no initializer for parameter {full!r}")


def build_model(cfg: Config, *, seed: Optional[int] = None,
                flat: Optional[Mapping[str, np.ndarray]] = None,
                device=None) -> GSTTacotron:
    """A GSTTacotron for ``cfg`` with weights from ``flat`` (JAX variables)
    or from a seeded init, on ``device`` (``cuda`` unless named), in eval
    mode, computing in ``model.compute_dtype`` (parameters float32)."""
    return _built(GSTTacotron(cfg.model, cfg.model.num_symbols or NUM_SYMBOLS,
                              dtype=getattr(torch, cfg.model.compute_dtype)),
                  seed, flat, device)


def build_wavernn(cfg: Config, *, seed: Optional[int] = None,
                  flat: Optional[Mapping[str, np.ndarray]] = None,
                  device=None) -> WaveRNN:
    """The WaveRNN vocoder of ``cfg.model.vocoder`` with weights from ``flat``
    (a JAX WaveRNN's variables, ``params/sample_embed/embedding``, ...) or
    from a seeded init, on ``device`` (``cuda`` unless named), in eval mode."""
    return _built(WaveRNN(cfg.model.vocoder, cfg.model.num_mels), seed, flat, device)


def _built(model: nn.Module, seed: Optional[int],
           flat: Optional[Mapping[str, np.ndarray]], device) -> nn.Module:
    if (seed is None) == (flat is None):
        raise ValueError("pass exactly one of seed and flat")
    if flat is not None:
        load_flat(model, flat)
    else:
        init_weights(model, seed)
    return model.to(resolve_device(device)).eval()

