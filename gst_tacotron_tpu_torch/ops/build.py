"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` exports a plain C launcher that takes device pointers,
sizes and a ``cudaStream_t`` and returns the ``cudaError_t`` of its launch.
It is compiled for ``sm_90a`` at first use into ``_build/`` inside the
package (listed in ``.gitignore``), under a name that carries a hash of the
sources, so an edited kernel is rebuilt and a built one is reused.
``build_all`` starts one nvcc per source, all at once.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
U64 = ctypes.c_uint64


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


class CudaKernel:
    """One CUDA source and its exported launcher, with a launch counter.

    ``launches`` counts successful launches made through ``__call__``; the
    ops wrapper calls it exactly where it launches the kernel. A kernel with
    named branches also counts each branch's launches in
    ``branch_launches``, from the ``branch`` its wrapper names: the form it
    launched the kernel in (K4 with location-sensitive taps), so a run shows
    which form served it."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 branches: Sequence[str] = ()):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.branch_launches = {b: 0 for b in branches}
        self._fn = None

    @property
    def name(self) -> str:
        return Path(self.source).stem

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / self.source]:
            h.update(path.name.encode())
            h.update(path.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc unless the library exists; returns the process."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.tmp_path, proc.out_path = tmp, out  # type: ignore[attr-defined]
        return proc

    def load(self):
        if self._fn is None:
            finish_builds([self.start_build()])
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.kernel_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn, self._err = lib, fn, err
        return self._fn

    def __call__(self, *args, branch: Optional[str] = None) -> None:
        rc = self.load()(*args)
        if rc != 0:
            msg = self._err(rc).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg} ({rc})")
        self.launches += 1
        if branch is not None:
            self.branch_launches[branch] += 1


def finish_builds(procs: Iterable[Optional[subprocess.Popen]]) -> None:
    """Wait for every started nvcc and move each library into place."""
    failures: List[str] = []
    for proc in procs:
        if proc is None:
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(proc.args)}\n{log}")
            continue
        # ptxas -v: registers, shared memory and spills of each kernel
        proc.out_path.with_suffix(".log").write_text(log)
        os.replace(proc.tmp_path, proc.out_path)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def build_all(kernels: Sequence[CudaKernel]) -> None:
    """Compile every kernel not built yet, one nvcc per source in parallel,
    then load them all."""
    finish_builds([k.start_build() for k in kernels])
    for k in kernels:
        k.load()


@functools.lru_cache(maxsize=8)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the kernels size
    their grids by it)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and any tensor requires grad: a kernel's
    output has no ``grad_fn``, so a training graph through it would leave
    every parameter before it untrained. Training runs the plain versions;
    inference runs under ``torch.no_grad()``."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires grad, and the kernel has no "
                           "backward; run it under torch.no_grad() or take the plain "
                           "version")


def check_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous float32/int32 CUDA tensor on
    one device (the kernels take raw pointers)."""
    import torch

    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"{name}: tensor on {t.device} but the current "
                             f"device is cuda:{torch.cuda.current_device()}")
        dev = t.device
        if t.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
