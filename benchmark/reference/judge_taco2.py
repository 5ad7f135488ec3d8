"""Judging a Tacotron 2 synthesis call (``reference/taco2.py``): the numbers
of ``judge.py`` with the post-net's mel in the linear spectrogram's place.

  style, mel, stop, align, frames   as ``judge.judge`` reads them (the mel
           with each decoder step fed the frame the outputs under test
           decoded before it);
  post     the post-net mel (the decoder's mel plus the post-net's
           residual) of the reference's own mel, relative over the
           reference's largest value;
  gl       Griffin-Lim's fit, as ``judge.judge`` reads it, to the magnitudes
           of the pseudo-inverse linear spectrogram of the reference's
           post-net mel (``taco2.MelGriffinLim``).

``control`` is the reference a precision down in the program's place, as
``judge.control``: TF32 for float32 products, float8 e4m3 for the style
wavs' transform and Griffin-Lim's iterations, which the configuration runs
on bfloat16 operands.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import dsp, taco2
from .judge import NUDGE, _rel, precision


def _synthesize(w, cfg: dict, run: dict, texts, wavs, seed: int, dev, fed=None,
                low: str = "bf16"):
    ref_mel, ref_len = dsp.reference_mels(wavs, cfg["audio"], dev, bf16=run["ref_mel_bf16"],
                                          low=low)
    return taco2.synthesize(w, cfg, texts, ref_mel, ref_len, seed, fed=fed,
                            ref_stack_bf16=run["ref_stack_bf16"],
                            text_pad=run["text_pad_multiple"])


@torch.no_grad()
def judge(w: Dict[str, torch.Tensor], cfg: dict, run: dict, texts: Sequence[str],
          wavs: Sequence[np.ndarray], seed: int, outputs: Dict[str, np.ndarray], *,
          device="cuda", **_) -> Dict[str, float]:
    """The numbers of one call's ``outputs`` (host arrays, as the program
    returned them) against the reference of its inputs."""
    dev = torch.device(device)
    put = lambda k: torch.from_numpy(np.ascontiguousarray(outputs[k])).to(dev)
    with precision(False):
        ref = _synthesize(w, cfg, run, texts, wavs, seed, dev, fed=put("mel").float())
        nums = {"style": _rel(put("style_embedding"), ref["style_embedding"]),
                "mel": _rel(put("mel"), ref["mel"]),
                "stop": _rel(put("stop_logits"), ref["stop_logits"]),
                "align": float((put("alignments") - ref["alignments"]).abs().max()),
                "frames": float((put("frame_lengths").to(torch.int64)
                                 != ref["frame_lengths"]).sum()),
                "post": _rel(put("mel_postnet"), ref["mel_postnet"])}
        gl = taco2.MelGriffinLim(cfg["audio"], dev)
        post = ref["mel_postnet"]
        target = gl.target(post)
        own = gl.convergence(gl(post), target)
        x = gl.convergence(outputs["wav"], target) / own - 1
        # Griffin-Lim from the post-net mel nudged by a relative NUDGE: how far
        # a row's fit swings by the iterations' chaos alone
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed % (1 << 63))
        nudged = post * (1 + NUDGE * torch.randn(post.shape, generator=gen, device=dev))
        y = gl.convergence(gl(nudged), target) / own - 1
        rms = lambda v: float(np.sqrt(np.mean(np.square(v))))
        nums["gl"] = rms(x) / max(rms(y), 1e-30)
    return nums


@torch.no_grad()
def control(w: Dict[str, torch.Tensor], cfg: dict, run: dict, texts: Sequence[str],
            wavs: Sequence[np.ndarray], seed: int, outputs: Dict[str, np.ndarray], *,
            device="cuda", **_) -> Dict[str, float]:
    """The numbers of the reference computed a precision down, put in the
    program's place and judged as the program is."""
    dev = torch.device(device)
    with precision(True):
        out = _synthesize(w, cfg, run, texts, wavs, seed, dev, low="fp8")
        host = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
                for k, v in out.items()}
        host["wav"] = taco2.MelGriffinLim(cfg["audio"], dev, low="fp8")(out["mel_postnet"])
    return judge(w, cfg, run, texts, wavs, seed, host, device=device)
