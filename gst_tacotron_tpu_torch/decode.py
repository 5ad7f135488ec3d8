"""Chunked early-exit autoregressive decoding (counterpart of
``gst_tacotron_tpu/decode.py``).

``Decoder.decode`` runs a fixed number of steps. ``chunked_decode`` runs
the same decode in chunks of ``chunk_steps`` and stops once every row's
stop token has fired:

    while chunks remain and not all rows finished:
        run the next chunk_steps steps; write them at the chunk's offset

Each chunk is one call of ``ops.decode.decode_scan`` on a carried
``DecodeCarry``: one launcher call of the decode kernel (K4) on the card,
which resumes from the workspace the chunk before left, writing straight
into the full output buffers at the chunk's offset (the kernel's outputs are
strided by the whole decode's steps). The loop is on the host; its only sync
is the one device-to-host read of ``all(finished)`` a chunk. A row is
finished once any of its stop logits so far has sigmoid > the stop
threshold. At stop threshold 1.0 no row finishes, every chunk runs, and the
result is that of one fixed-length call over the same steps, bit for bit.

``all_reduce`` makes every rank of a data-parallel synthesis agree on when
to stop: ``data_parallel_stop_consensus`` is the ``torch.distributed``
hook (MIN over the ranks of each rank's ``all(finished)``).

The JAX package runs its chunked mode on its scan decoder, not its decode
kernel; here the chunks run on K4, and ``plain=True`` takes the kernel's
plain version.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from .models.decoder import mask_frames
from .models.modules import length_mask
from .ops.decode import decode_carry, decode_scan, decode_scan_plain


def chunked_decode(model, memory: torch.Tensor, memory_lengths: torch.Tensor, *,
                   chunk_steps: int = 64, max_steps: Optional[int] = None,
                   all_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                   deterministic_prenet: bool = False, seed: int = 0,
                   plain: bool = False) -> Dict[str, torch.Tensor]:
    """Decode ``memory`` (B, T, M) of a ``GSTTacotron`` in chunks -> {mel
    (B, N * r, M), stop_logits (B, N * r), alignments (B, N, T),
    frame_lengths (B,), chunks_run (int)}, N = ceil(max_steps / chunk_steps)
    * chunk_steps, the budget of the JAX package; buffers past the chunks
    run stay zero. The decoder's prenet dropout draws from the Philox stream
    ``seed`` (as ``Decoder.decode``), off with ``deterministic_prenet``."""
    if chunk_steps < 1:
        raise ValueError(f"chunk_steps must be positive, got {chunk_steps}")
    dec = model.decoder
    cfg = dec.cfg
    r = cfg.reduction_factor
    max_steps = max_steps or cfg.max_decode_steps
    num_chunks = math.ceil(max_steps / chunk_steps)
    b = memory.shape[0]
    f32 = torch.float32
    keys = dec.cell.precompute_keys(memory).to(f32)
    memory = memory.to(f32)
    packed = dec.cell.pack()
    run = decode_scan_plain if plain else decode_scan
    carry = decode_carry(memory, dec_cfg=cfg, num_mels=dec.num_mels,
                         total_steps=num_chunks * chunk_steps)
    finished = torch.zeros(b, dtype=torch.bool, device=memory.device)
    chunks_run = 0
    while chunks_run < num_chunks:
        done = finished if all_reduce is None else all_reduce(finished)
        if bool(done.all()):
            break
        run(packed, memory, keys, memory_lengths, dec_cfg=cfg, attn_cfg=dec.attn_cfg,
            num_mels=dec.num_mels, steps=chunk_steps, seed=seed,
            use_dropout=not deterministic_prenet, carry=carry)
        stops = carry.stop_logits[:, chunks_run * chunk_steps * r:
                                  (chunks_run + 1) * chunk_steps * r]
        finished |= (torch.sigmoid(stops) > cfg.stop_threshold).any(dim=1)
        chunks_run += 1

    written = chunks_run * chunk_steps * r
    n = carry.stop_logits.shape[1]
    if cfg.use_stop_token:
        stopped = torch.sigmoid(carry.stop_logits) > cfg.stop_threshold
        stopped &= length_mask(torch.full((b,), written, device=memory.device), n)
        first = torch.argmax(stopped.to(torch.int32), dim=1) + 1
        frame_lengths = torch.where(stopped.any(dim=1), first, torch.full_like(first, written))
    else:
        frame_lengths = torch.full((b,), written, dtype=torch.int64, device=memory.device)
    return {"mel": mask_frames(carry.mel, frame_lengths), "stop_logits": carry.stop_logits,
            "alignments": carry.aligns, "frame_lengths": frame_lengths,
            "chunks_run": chunks_run}


def data_parallel_stop_consensus(group=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The ``all_reduce`` hook of a data-parallel synthesis: every rank
    learns whether all rows of all ranks are finished (MIN over the ranks of
    each rank's ``all(finished)``, over ``group``, the default group when
    None). Returns ``finished``-shaped flags, all equal."""
    import torch.distributed as dist

    def reduce(finished: torch.Tensor) -> torch.Tensor:
        dev = finished.device if dist.get_backend(group) == "nccl" else torch.device("cpu")
        local = finished.all().to(device=dev, dtype=torch.int32).reshape(1)
        dist.all_reduce(local, op=dist.ReduceOp.MIN, group=group)
        return local.to(finished.device).bool().expand_as(finished)

    return reduce
