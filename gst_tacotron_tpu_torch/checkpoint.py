"""Checkpointing (counterpart of ``gst_tacotron_tpu/checkpoint.py``).

One ``torch.save`` file a step, ``step_<n>.pt`` in the directory, holding
what the trainer hands over: the step, the model's state dict (parameters
and BatchNorm buffers), the Adam moments with their count, and the dropout
stream's root. Written to a temporary name and renamed, so a crash never
leaves a half-written checkpoint; the oldest beyond ``keep`` are removed.
Saves are synchronous (the state lives on the card and is copied to the
host as it is written), so ``wait`` has nothing to wait for.

The directory may also hold ``step_<n>.npz``: a JAX package checkpoint
exported by ``tools/export_jax_workdir.py`` (its orbax state as flat
arrays). ``restore`` reads it into the same layout (``read_jax_export``),
without a dropout root (the JAX key is not carried; the trainer keeps its
own), so every reader of a port workdir also takes an exported JAX one.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_NAME = re.compile(r"^step_(\d+)\.(pt|npz)$")


def read_jax_export(path: str, map_location=None) -> Dict[str, Any]:
    """An exported JAX state -> ``train.state_dict``'s layout: ``step``,
    ``model`` (state-dict keys: parameters and BatchNorm buffers) and
    ``opt`` {count, mu, nu} (by parameter name), float32 tensors on
    ``map_location``. Raises where Adam's and the schedule's counts differ
    (the chain moves them together)."""
    from .weights import flat_key_to_state_key

    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    dev = torch.device("cpu") if map_location is None else map_location

    def tensors(prefix: str, collection: str = "") -> Dict[str, torch.Tensor]:
        """The arrays under ``prefix`` by state-dict key (``prefix`` read as
        ``collection``)."""
        return {flat_key_to_state_key(collection + k[len(prefix):] if collection else k):
                torch.from_numpy(np.asarray(v, np.float32)).to(dev)
                for k, v in arrays.items() if k.startswith(prefix)}

    count = int(arrays["opt/count"])
    if "opt/schedule_count" in arrays and int(arrays["opt/schedule_count"]) != count:
        raise ValueError(f"{path}: Adam's count {count} differs from the schedule's "
                         f"{int(arrays['opt/schedule_count'])}")
    return {"step": int(arrays["step"]),
            "model": {**tensors("params/"), **tensors("batch_stats/")},
            "opt": {"count": count, "mu": tensors("opt/mu/", "params/"),
                    "nu": tensors("opt/nu/", "params/")}}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _files(self) -> Dict[int, str]:
        """{step: file name}; a port checkpoint wins over an export of the
        same step."""
        files: Dict[int, str] = {}
        for name in sorted(os.listdir(self.directory), key=lambda n: n.endswith(".pt")):
            m = _NAME.match(name)
            if m:
                files[int(m.group(1))] = name
        return files

    def all_steps(self) -> List[int]:
        return sorted(self._files())

    def save(self, step: int, state: Dict[str, Any]) -> None:
        path = os.path.join(self.directory, f"step_{step:08d}.pt")
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        files = self._files()
        for old in sorted(files)[:-self.keep] if self.keep > 0 else []:
            os.remove(os.path.join(self.directory, files[old]))

    def restore(self, step: Optional[int] = None, map_location=None) -> Dict[str, Any]:
        """The saved state of ``step`` (the latest when None), its tensors on
        ``map_location``: a port checkpoint, or an exported JAX one."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = os.path.join(self.directory, self._files()[step])
        if path.endswith(".npz"):
            return read_jax_export(path, map_location)
        return torch.load(path, map_location=map_location, weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX manager's interface."""

    def close(self) -> None:
        self.wait()
