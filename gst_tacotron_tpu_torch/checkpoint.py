"""Checkpointing (counterpart of ``gst_tacotron_tpu/checkpoint.py``).

One ``torch.save`` file a step, ``step_<n>.pt`` in the directory, holding
what the trainer hands over: the step, the model's state dict (parameters
and BatchNorm buffers), the Adam moments with their count, and the dropout
stream's root. Written to a temporary name and renamed, so a crash never
leaves a half-written checkpoint; the oldest beyond ``keep`` are removed.
Saves are synchronous (the state lives on the card and is copied to the
host as it is written), so ``wait`` has nothing to wait for. Reading the
JAX package's orbax checkpoints is not ported.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def save(self, step: int, state: Dict[str, Any]) -> None:
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.keep] if self.keep > 0 else []:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None, map_location=None) -> Dict[str, Any]:
        """The saved state of ``step`` (the latest when None), its tensors on
        ``map_location``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX manager's interface."""

    def close(self) -> None:
        self.wait()
