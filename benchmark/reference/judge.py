"""Judging a synthesis call's outputs against the plain reference.

``judge`` works every stage out again from the call's inputs (texts, style
wavs, seed) and the benchmark's weights, reads the outputs under test only
to compare them, and returns the numbers the cell holds to its limits:

  style    widest |difference| of the style embedding, over the largest
           |reference value|;
  mel      the same for the decoded mel, each decoder step fed the frame
           that the outputs under test decoded before it (a drift in one
           step shows in that step and is not carried on by the feedback);
  stop     the same for the stop logits;
  align    widest |difference| of the attention weights;
  frames   rows whose stop length differs (an exact count);
  linear   the post-net's linear spectrogram of the reference's own mel,
           as ``mel``;
  gl       (Griffin-Lim vocoder) how well the waveform fits, as a
           multiple of Griffin-Lim's own chaos. Fast Griffin-Lim (momentum
           0.99, operands rounded to bfloat16) is chaotic in its phases:
           inputs that differ by 1e-7 give waveforms that differ sample by
           sample by a sixth of their peak, so samples are not compared. A
           row's spectral convergence (how far the magnitudes of a
           waveform lie from the magnitudes Griffin-Lim fits to the
           reference's linear spectrogram) is read for the waveform under
           test and for the reference's own Griffin-Lim waveform, and its
           ratio less 1 taken for every row; the same is read for the
           reference's Griffin-Lim from the spectrogram nudged by a
           relative 1e-6, which is how far the fit swings by chaos alone on
           this call. ``gl`` is the root mean square over rows of the first,
           over that of the second;
  gap      the widest score gap of the sampled mu-law classes (WaveRNN
           vocoder): how far a sampled class scores below the best class of
           its step, scored on the classes that were sampled.

``control`` is the reference put in the program's place in the next
precision down: float32 products in TF32, and the products the
configuration states on bfloat16 operands (the style wavs' transform,
Griffin-Lim's) on float8 e4m3 operands under a scale a tensor (and the
WaveRNN's classes that the TF32 scores put first), as the program would
hand the call over.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from . import dsp, tacotron, wavernn

VOCODER_SEED_OFFSET = 104729
# the relative size of the nudge that measures Griffin-Lim's chaos
NUDGE = 1e-6


@contextlib.contextmanager
def precision(tf32: bool) -> Iterator[None]:
    """Float32 products in float32 (``tf32`` False) or in TF32, for the
    block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a - ref).abs().max() / torch.clamp(ref.abs().max(), min=1e-30))


def _synthesize(w, cfg: dict, run: dict, texts, wavs, seed: int, dev, fed=None,
                low: str = "bf16"):
    a = cfg["audio"]
    ref_mel, ref_len = dsp.reference_mels(wavs, a, dev, bf16=run["ref_mel_bf16"], low=low)
    return tacotron.synthesize(w, cfg, texts, ref_mel, ref_len, seed, fed=fed,
                               ref_stack_bf16=run["ref_stack_bf16"],
                               text_pad=run["text_pad_multiple"])


@torch.no_grad()
def judge(w: Dict[str, torch.Tensor], cfg: dict, run: dict, texts: Sequence[str],
          wavs: Sequence[np.ndarray], seed: int, outputs: Dict[str, np.ndarray], *,
          vocoder_w: Optional[Dict[str, torch.Tensor]] = None,
          gap_rows: Sequence[int] = (), gap_picks: Optional[torch.Tensor] = None,
          device="cuda") -> Dict[str, float]:
    """The numbers of one call's ``outputs`` (host arrays, as the program
    returned them) against the reference of its inputs. ``gap_picks``
    replaces the sampled classes as the ones read (a control's)."""
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
                "linear": _rel(put("linear"), ref["linear"])}
        if vocoder_w is None:
            gl = dsp.GriffinLim(cfg["audio"], dev)
            target = gl.target(ref["linear"])
            own = gl.convergence(gl(ref["linear"]), target)
            x = gl.convergence(outputs["wav"], target) / own - 1
            # the same Griffin-Lim from the spectrogram nudged by a relative
            # NUDGE: how far a row's fit swings by the iterations' chaos alone
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed % (1 << 63))
            lin = ref["linear"]
            nudged = lin * (1 + NUDGE * torch.randn(lin.shape, generator=gen, device=dev))
            y = gl.convergence(gl(nudged), target) / own - 1
            rms = lambda v: float(np.sqrt(np.mean(np.square(v))))
            nums["gl"] = rms(x) / max(rms(y), 1e-30)
        else:
            v = cfg["model"]["vocoder"]
            classes = torch.from_numpy(wavernn.mulaw_classes(outputs["wav"],
                                                             v["wavernn_bits"])).to(dev)
            nums["gap"] = wavernn.widest_gap(vocoder_w, ref["mel"], classes,
                                             hop=v["wavernn_hop"],
                                             seed=seed + VOCODER_SEED_OFFSET, rows=gap_rows,
                                             picks=gap_picks)
    return nums


@torch.no_grad()
def control(w: Dict[str, torch.Tensor], cfg: dict, run: dict, texts: Sequence[str],
            wavs: Sequence[np.ndarray], seed: int, outputs: Dict[str, np.ndarray], *,
            vocoder_w: Optional[Dict[str, torch.Tensor]] = None,
            gap_rows: Sequence[int] = (), device="cuda") -> Dict[str, float]:
    """The numbers of the reference computed a precision down (TF32 for
    float32, float8 for bfloat16), put in the program's place and judged as
    the program is. A WaveRNN's sampled
    classes are not drawn again: at each step of the program's ``outputs``
    the class that TF32 scores put first is read against the float32
    scores."""
    dev = torch.device(device)
    with precision(True):
        out = _synthesize(w, cfg, run, texts, wavs, seed, dev, low="fp8")
        host = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
                for k, v in out.items()}
        if vocoder_w is None:
            host["wav"] = dsp.GriffinLim(cfg["audio"], dev, low="fp8")(out["linear"])
    if vocoder_w is None:
        return judge(w, cfg, run, texts, wavs, seed, host, device=device)
    v = cfg["model"]["vocoder"]
    classes = torch.from_numpy(wavernn.mulaw_classes(outputs["wav"],
                                                     v["wavernn_bits"])).to(dev)
    with precision(True):
        picks = wavernn.first_choices(vocoder_w, out["mel"], classes, hop=v["wavernn_hop"],
                                      seed=seed + VOCODER_SEED_OFFSET, rows=gap_rows)
    return judge(w, cfg, run, texts, wavs, seed, {**host, "wav": outputs["wav"]},
                 vocoder_w=vocoder_w, gap_rows=gap_rows, gap_picks=picks, device=device)
