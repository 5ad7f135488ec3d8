"""Device selection shared by the port's entry points, and the copy of a
result to the host that the program counts."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .utils.profiling import count


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. With no card and no explicit device this raises: the plain CPU
    path runs only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host; a copy from the card adds its bytes to the
    ``d2h_bytes`` counter and one to ``host_syncs`` (each such copy blocks
    the host until the card has computed ``t``)."""
    a = t.cpu().numpy()
    if t.is_cuda:
        count("d2h_bytes", a.nbytes)
        count("host_syncs")
    return a
