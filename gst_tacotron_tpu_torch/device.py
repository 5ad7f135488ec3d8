"""Device selection shared by the port's entry points, and the copies of
results to the host that the program counts.

A copy from the card lands in pinned host memory (PyTorch's caching host
allocator), enqueued on the device's copy stream after the work the
current stream has enqueued, so it can run on the copy engine while later
kernels run. ``HostCopies`` gathers one call's copies and waits once;
``to_numpy`` is one copy and its wait."""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from .utils.profiling import count

# each result's offset in a call's pinned block: a multiple of every dtype's size
_ALIGN = 64


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


# the stream each card's copies to the host run on, by device index
_COPY_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream a card's copies to the host run on: one a card, made at
    its first copy."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _COPY_STREAMS:
        _COPY_STREAMS[index] = torch.cuda.Stream(device=index)
    return _COPY_STREAMS[index]


class HostCopies:
    """Host arrays of device tensors, copied as the caller starts them and
    handed out by one ``wait``.

    ``start`` enqueues a group: CUDA tensors are copied into one freshly
    allocated pinned block (so a later call never writes into arrays an
    earlier one returned), on the copy stream, after everything the current
    stream has enqueued; each source is recorded on the copy stream, so the
    caching device allocator does not hand its memory out again before its
    copy ends. Other tensors are taken as ``t.cpu().numpy()``. The bytes of
    the host arrays copied from the card add to ``d2h_bytes``; ``wait``
    blocks the host once, on the last copy, and adds one to ``host_syncs``.
    """

    def __init__(self):
        self.arrays: Dict[str, np.ndarray] = {}
        self._done: Optional[torch.cuda.Event] = None

    def __contains__(self, key: str) -> bool:
        return key in self.arrays

    def start(self, tensors: Dict[str, torch.Tensor]) -> int:
        """Enqueue the copies of ``tensors`` (each is copied as it is, dtype
        and shape); returns the bytes enqueued from the card."""
        on_card = {}
        for k, t in tensors.items():
            if t.is_cuda:
                on_card[k] = t.contiguous()
            else:
                self.arrays[k] = t.cpu().numpy()
        if not on_card:
            return 0
        sizes = {k: t.numel() * t.element_size() for k, t in on_card.items()}
        offsets, total = {}, 0
        for k, n in sizes.items():
            offsets[k] = total
            total += -(-n // _ALIGN) * _ALIGN
        block = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        device = next(iter(on_card.values())).device
        stream = _copy_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for k, t in on_card.items():
                host = block[offsets[k]: offsets[k] + sizes[k]].view(t.dtype).view(t.shape)
                host.copy_(t, non_blocking=True)
                t.record_stream(stream)
                self.arrays[k] = host.numpy()
            self._done = torch.cuda.Event()
            self._done.record(stream)
        nbytes = sum(sizes.values())
        count("d2h_bytes", nbytes)
        return nbytes

    def wait(self) -> Dict[str, np.ndarray]:
        """Every started array, once its copy has ended."""
        if self._done is not None:
            self._done.synchronize()
            self._done = None
            count("host_syncs")
        return self.arrays


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host, blocking: one ``HostCopies`` group and its wait
    (from the card: its bytes add to ``d2h_bytes``, its wait one to
    ``host_syncs``)."""
    copies = HostCopies()
    copies.start({"t": t})
    return copies.wait()["t"]
