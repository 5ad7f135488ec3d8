"""Distributed batch synthesis over a mesh (counterpart of
``gst_tacotron_tpu/parallel/distributed_synthesis.py``).

Every rank runs the port's kernel path on its rows of the global batch: K3
on its reference wavs, K2 and K1 for the style, the encoder (K1), the decode
(K4), the post-net (K1), then Griffin-Lim or, with a WaveRNN vocoder, K5;
then the rows are all-gathered over the data axis, so every rank returns the
whole batch (padding rows trimmed by ``synthesize``). Two modes:

  * fixed length (the default): the JAX package's one global program. A
    rank's rows draw their dropout as rows ``row0 ..`` of the global batch
    (``models.modules.data_parallel``: the encoder prenet's mask, K4's and
    K5's Philox streams), so the result is the single-process
    ``Synthesizer``'s on the same rows;
  * chunked (``chunked=True``): ``decode.chunked_decode`` with the stop
    consensus over the data axis (``data_parallel_stop_consensus``), so
    every rank stops after the same chunk; as the JAX ``shard_map`` program,
    a rank draws its dropout as a batch of its own, from the seed folded
    with its data index (``fold_seed``). Refused under a model axis > 1.

K4 and K5 hold whole weights in their workspaces, so under a model axis > 1
the synthesizer gathers a sharded model's kernels once, at construction (the
JAX package computes with the shards, GSPMD inserting the collectives); the
ranks of a model group then compute the same rows.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..decode import data_parallel_stop_consensus
from ..models.modules import data_parallel
from ..models.tacotron import GSTTacotron
from ..ops.philox import philox4x32_10, seed_key
from ..synthesize import Synthesizer
from ..utils.profiling import next_call, span
from ..weights import build_model
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_gather, rank_device, shard_rows
from .sharding import whole_copy


def fold_seed(seed: int, index: int) -> int:
    """A 64-bit seed of its own for data index ``index`` (``jax.random
    .fold_in``'s role): one Philox4x32-10 call counted by ``index`` under the
    seed's key."""
    words = philox4x32_10(tuple(np.full(1, x, np.uint64) for x in (index, 0, 0, 7)),
                          seed_key(seed))
    return (int(words[1][0]) << 32) | int(words[0][0])


class DistributedSynthesizer:
    """Mesh-sharded synthesis: utterances split over ``data``, kernels whole
    on every rank. ``model`` carries its weights (as the port's
    ``Synthesizer`` takes it); ``vocoder`` is a ``vocoder.make_vocoder``
    object (None: Griffin-Lim). ``device`` is the rank's card unless named."""

    def __init__(self, cfg: Config, model: GSTTacotron, mesh: Mesh, *, device=None,
                 vocoder=None, text_pad_multiple: int = 32, plain: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        device_of = next(model.parameters()).device
        model = whole_copy(model, mesh, lambda: build_model(cfg, seed=0, device=device_of))
        self.synth = Synthesizer(cfg, model, device=rank_device(device), vocoder=vocoder,
                                 text_pad_multiple=text_pad_multiple, plain=plain)
        self.device = self.synth.device
        self.model = self.synth.model
        self.vocoder_model = getattr(vocoder, "model", None)

    def _local(self, tok, tok_len, ref_mel, ref_lengths, token_weights, speaker_ids, *,
               seed: int = 0, max_steps: Optional[int] = None, chunked: bool = False,
               chunk_steps: int = 64, deterministic_prenet: bool = False) -> Dict[str, Any]:
        """This rank's rows through the synthesizer, then the data axis's
        rows gathered: the whole batch's outputs on the device."""
        mesh = self.mesh
        steps = max_steps or self.cfg.model.decoder.max_decode_steps
        kw = dict(max_steps=steps, deterministic_prenet=deterministic_prenet)
        with torch.no_grad(), span("gst.dsynth.local"):
            if chunked:
                if mesh.shape[MODEL_AXIS] != 1:
                    raise ValueError("chunked consensus decoding shards over `data` with "
                                     "whole kernels; build the mesh with "
                                     "model_parallelism=1")
                index, _ = mesh.coords()
                out = self.synth.infer(
                    tok, tok_len, ref_mel, ref_lengths, token_weights, speaker_ids,
                    seed=fold_seed(seed, index), chunk_steps=chunk_steps,
                    stop_all_reduce=data_parallel_stop_consensus(mesh.data_group), **kw)
            else:
                shard = mesh.data_shard()
                with contextlib.ExitStack() as stack:
                    for m in (self.model, self.vocoder_model):
                        if m is not None:
                            stack.enter_context(data_parallel(m, shard))
                    out = self.synth.infer(tok, tok_len, ref_mel, ref_lengths,
                                           token_weights, speaker_ids, seed=seed,
                                           chunk_steps=None, **kw)
        b = tok.shape[0]
        with span("gst.dsynth.gather"):
            return {k: all_gather(v, mesh.data_group)
                    if torch.is_tensor(v) and v.dim() and v.shape[0] == b else v
                    for k, v in out.items()}

    def _to_device(self, a) -> Optional[torch.Tensor]:
        if a is None or torch.is_tensor(a):
            return None if a is None else a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    def __call__(self, tokens, token_lengths, ref_mel=None, ref_mel_lengths=None,
                 token_weights=None, speaker_ids=None, seed: int = 0,
                 max_steps: Optional[int] = None, chunked: bool = False,
                 chunk_steps: int = 64, deterministic_prenet: bool = False
                 ) -> Dict[str, Any]:
        """The global batch (B, L) tokens, B divisible by the data axis's
        size, with the GST conditioning inputs, on every rank -> the whole
        batch's outputs on the device (``mel``, ``linear``, ``stop_logits``,
        ``alignments``, ``frame_lengths``, ``wav``; ``chunks_run``, equal on
        every rank, when chunked)."""
        lo, hi = shard_rows(len(tokens), self.mesh)
        rows = lambda a: None if a is None else self._to_device(a)[lo:hi]
        tok = rows(tokens).long()
        return self._local(tok, rows(token_lengths).long(), rows(ref_mel),
                           rows(ref_mel_lengths), rows(token_weights), rows(speaker_ids),
                           seed=seed, max_steps=max_steps, chunked=chunked,
                           chunk_steps=chunk_steps, deterministic_prenet=deterministic_prenet)

    def synthesize(self, texts: Sequence[str],
                   reference_wavs: Optional[Sequence[np.ndarray]] = None,
                   token_weights: Optional[np.ndarray] = None,
                   speaker_ids: Optional[Sequence[int]] = None,
                   **call_kwargs) -> Dict[str, np.ndarray]:
        """Texts (and reference wavs) -> host arrays of the whole batch, as
        ``Synthesizer.__call__`` returns them. The batch is padded to a
        multiple of the data axis's size by repeating its last row; the
        padding rows are trimmed from the result. Each rank extracts the
        reference mels of its own rows (K3), padded to the longest of all
        rows. ``call_kwargs`` pass to ``__call__`` (seed, max_steps,
        chunked, chunk_steps, deterministic_prenet)."""
        cfg = self.cfg
        n = len(texts)
        with span("gst.dsynth", call=next_call()):
            from_wavs = cfg.model.gst.enabled and reference_wavs is not None
            with span("gst.synth.frontend"):
                host = self.synth.text_inputs(texts, from_wavs, token_weights, speaker_ids)
            pad_b = -n % self.mesh.shape[DATA_AXIS]

            def pad_rows(a):
                if a is None or pad_b == 0:
                    return a
                return np.concatenate([a, np.repeat(a[-1:], pad_b, axis=0)], 0)

            host = {k: pad_rows(v) for k, v in host.items()}
            lo, hi = shard_rows(n + pad_b, self.mesh)
            ref_mel = ref_lengths = None
            if from_wavs:
                wavs = list(reference_wavs) + [reference_wavs[-1]] * pad_b
                # every rank pads to the longest reference of the whole batch
                # (a wav's frames as DeviceFeatureExtractor frames it)
                frames = max(1 + len(w) // cfg.audio.hop_length for w in wavs)
                with span("gst.synth.ref_mels"):
                    ref_mel, ref_lengths = self.synth._reference_mels(wavs[lo:hi], frames)
            put = lambda a: None if a is None else self._to_device(a[lo:hi])
            out = self._local(put(host["tokens"]), put(host["token_lengths"]), ref_mel,
                              ref_lengths, put(host["token_weights"]),
                              put(host["speaker_ids"]), **call_kwargs)
            with span("gst.dsynth.to_host"):
                result = self.synth.to_host(out, self._to_device(host["token_lengths"]))
        return {k: v[:n] if isinstance(v, np.ndarray) and v.ndim and v.shape[0] == n + pad_b
                else v for k, v in result.items()}
