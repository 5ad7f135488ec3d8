"""Host-side input pipeline (counterpart of ``gst_tacotron_tpu/data/loader.py``).

Deterministic sampling, length-bucketed fixed-shape batches, r-aligned mel
padding, per-host sharding of each global batch and a bounded background
prefetch queue. Numpy only: the batches are the JAX loader's, bit for bit,
from either package's pattern directory.

Feature batches (``data.wav_transport`` off):
  tokens        (B, L_bucket) int32, PAD = 0
  token_lengths (B,) int32
  mel           (B, T_bucket, num_mels) float32   (T_bucket % r == 0)
  mel_lengths   (B,) int32, r-aligned, <= T_bucket
  linear        (B, T_bucket, num_freq) float32
  speaker_ids   (B,) int32

Wav-transport batches: {"wav" float16 (B, L_sig), "ints" int32 (B, L_bucket
+ 4)}: preemphasized, centre-padded waveforms and one packed sidecar per
batch; ``train._materialize_features`` computes mel and linear on the
device. ``build_wav_corpus`` preps the whole split once per bucket for a
device-resident corpus, and ``stream_indices`` streams row indices into it.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import AudioConfig, DataConfig
from ..dsp import ref as dsp_ref

Batch = Dict[str, np.ndarray]

# The wav wire type: float16, whose ~1e-3 relative error stays ~1e-4 after dB
# normalization at every level (int16's absolute error is amplified in
# near-silent bins). Two bytes a sample either way.
WAV_WIRE_DTYPE = np.float16


@dataclass
class BucketSpec:
    max_text: int
    max_frames: int  # r-aligned at construction


def _align_up(x: int, r: int) -> int:
    return ((x + r - 1) // r) * r


def entry_split(entry_id: str, val_fraction: float) -> str:
    """Deterministic, corpus-order-independent train/val assignment."""
    if val_fraction <= 0.0:
        return "train"
    h = int.from_bytes(hashlib.md5(entry_id.encode()).digest()[:4], "big")
    return "val" if (h % 1000) < val_fraction * 1000 else "train"


class PatternDataset:
    """Metadata-indexed view over a pattern directory."""

    def __init__(self, pattern_dir: str, metadata_file: str = "metadata.json"):
        self.pattern_dir = pattern_dir
        with open(os.path.join(pattern_dir, metadata_file)) as f:
            self.metadata = json.load(f)
        self.entries = self.metadata["entries"]
        self.num_speakers = max(1, int(self.metadata.get("num_speakers", 1)))

    def __len__(self) -> int:
        return len(self.entries)

    def load(self, idx: int, wav_only: bool = False) -> Dict[str, np.ndarray]:
        """``wav_only`` skips decompressing the mel and linear members (the
        wav-transport loader never reads them)."""
        entry = self.entries[idx]
        with np.load(os.path.join(self.pattern_dir, entry["file"]),
                     allow_pickle=False) as z:
            out = {"tokens": z["tokens"], "speaker_id": z["speaker_id"]}
            if not wav_only:
                # wav-only shards carry no features (BucketedLoader rejects
                # them up front in feature mode)
                for key in ("mel", "linear"):
                    if key in z:
                        out[key] = z[key]
            if "wav" in z:
                out["wav"] = z["wav"]
            return out


class BucketedLoader:
    """Deterministic, shardable, bucketed batch iterator with prefetch."""

    def __init__(
        self,
        dataset: PatternDataset,
        cfg: DataConfig,
        reduction_factor: int,
        *,
        batch_size: Optional[int] = None,
        shard_index: int = 0,
        num_shards: int = 1,
        seed: int = 0,
        drop_remainder: bool = True,
        split: str = "train",
        audio_cfg: Optional[AudioConfig] = None,
    ):
        """split: "train" | "val" | "all", assigned by ``entry_split`` with
        cfg.val_fraction. ``audio_cfg`` is required with cfg.wav_transport
        (the wav rows need hop, n_fft and preemphasis)."""
        self.dataset = dataset
        self.cfg = cfg
        self.r = reduction_factor
        self.batch_size = batch_size or cfg.batch_size
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.split = split
        self.audio = audio_cfg
        self.corpus_row: Optional[Dict[int, Tuple[int, int]]] = None
        if not cfg.wav_transport:
            wav_only = [e["id"] for e in dataset.entries if e.get("wav_only")]
            if wav_only:
                raise ValueError(
                    f"{len(wav_only)} pattern(s) are wav-only shards (e.g. "
                    f"{wav_only[:3]}) with no offline features; train with "
                    "data.wav_transport=true or regenerate without --wav-only")
        else:
            if audio_cfg is None:
                raise ValueError("wav_transport requires audio_cfg")
            missing = [e["id"] for e in dataset.entries if not e.get("has_wav")]
            if missing:
                raise ValueError(
                    f"data.wav_transport=True but {len(missing)} pattern(s) "
                    "were generated without --store-wav (e.g. "
                    f"{missing[:3]}); regenerate with --store-wav")

        self.buckets = [BucketSpec(t, _align_up(f, self.r)) for t, f in cfg.buckets]
        # each entry goes to its smallest fitting bucket; entries that fit
        # none are counted and reported, never dropped silently
        self.bucket_members: List[List[int]] = [[] for _ in self.buckets]
        self.dropped_short = 0
        self.dropped_overflow = 0
        self.other_split = 0
        for i, e in enumerate(dataset.entries):
            if split != "all" and entry_split(e["id"], cfg.val_fraction) != split:
                self.other_split += 1
                continue
            if e["text_len"] < cfg.min_text_len:
                self.dropped_short += 1
                continue
            for b, spec in enumerate(self.buckets):
                if e["text_len"] <= spec.max_text and e["mel_len"] <= spec.max_frames:
                    self.bucket_members[b].append(i)
                    break
            else:
                self.dropped_overflow += 1
        if self.dropped_overflow or self.dropped_short:
            print(f"[loader] dropped {self.dropped_overflow} entries exceeding "
                  f"every bucket and {self.dropped_short} below min_text_len "
                  f"(of {len(dataset.entries)}); bucket sizes "
                  f"{[len(m) for m in self.bucket_members]}")

    # -- batch assembly -------------------------------------------------------

    def _assemble(self, indices: Sequence[int], spec: BucketSpec) -> Batch:
        n = len(indices)
        if self.cfg.wav_transport:
            items = [self.dataset.load(idx, wav_only=True) for idx in indices]
            return self._assemble_wav(items, spec, n)
        items = [self.dataset.load(idx) for idx in indices]
        num_mels = items[0]["mel"].shape[1]
        num_freq = items[0]["linear"].shape[1]
        tokens = np.zeros((n, spec.max_text), np.int32)
        token_lengths = np.zeros((n,), np.int32)
        mel = np.zeros((n, spec.max_frames, num_mels), np.float32)
        linear = np.zeros((n, spec.max_frames, num_freq), np.float32)
        mel_lengths = np.zeros((n,), np.int32)
        speaker_ids = np.zeros((n,), np.int32)
        for j, item in enumerate(items):
            t = item["tokens"][: spec.max_text]
            tokens[j, : len(t)] = t
            token_lengths[j] = len(t)
            m = item["mel"][: spec.max_frames]
            lin = item["linear"][: spec.max_frames]
            mel[j, : m.shape[0]] = m
            linear[j, : lin.shape[0]] = lin
            # r-aligned true length (frames beyond are zero padding)
            mel_lengths[j] = min(_align_up(m.shape[0], self.r), spec.max_frames)
            speaker_ids[j] = int(item["speaker_id"])
        return {"tokens": tokens, "token_lengths": token_lengths, "mel": mel,
                "mel_lengths": mel_lengths, "linear": linear, "speaker_ids": speaker_ids}

    def _assemble_wav(self, items: Sequence[Dict[str, np.ndarray]], spec: BucketSpec,
                      n: int) -> Batch:
        """Wav-transport batch: {"wav" float16 (B, L), "ints" int32 (B, T + 4)}.

        The host does only the per-utterance prep that must match the numpy
        oracle exactly (float64 preemphasis and the reflect centre pad, as
        ``DeviceFeatureExtractor._prep``), zero-pads to the bucket's signal
        length and halves to float16. The int32 sidecar row is
        [tokens (T_bucket), token_len, mel_len (r-aligned), true_frames,
        speaker_id]."""
        sig_len = (spec.max_frames - 1) * self.audio.hop_length + self.audio.n_fft
        wav = np.zeros((n, sig_len), WAV_WIRE_DTYPE)
        ints = np.zeros((n, spec.max_text + 4), np.int32)
        for j, item in enumerate(items):
            self._fill_wav_row(item, spec, wav[j], ints[j])
        return {"wav": wav, "ints": ints}

    def _fill_wav_row(self, item: Dict[str, np.ndarray], spec: BucketSpec,
                      wav_row: np.ndarray, ints_row: np.ndarray) -> None:
        """Prep one utterance into preallocated wire rows; shared by the batch
        assembler and the corpus builder, so their rows are bit-identical."""
        hop, n_fft = self.audio.hop_length, self.audio.n_fft
        sig_len = (spec.max_frames - 1) * hop + n_fft
        t = item["tokens"][: spec.max_text]
        ints_row[: len(t)] = t
        w = np.asarray(item["wav"], np.float64)
        frames = min(1 + len(w) // hop, spec.max_frames)
        pre = dsp_ref.preemphasis(w, self.audio.preemphasis)
        sig = np.pad(pre, (n_fft // 2, n_fft // 2), mode="reflect")[:sig_len]
        wav_row[: len(sig)] = sig.astype(WAV_WIRE_DTYPE)
        mlen = min(_align_up(frames, self.r), spec.max_frames)
        ints_row[spec.max_text: spec.max_text + 4] = (len(t), mlen, frames,
                                                     int(item["speaker_id"]))

    # -- device-resident corpus (index wire) ------------------------------------

    def build_wav_corpus(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """Every split entry prepped once, per occupied bucket, at the
        bucket's shapes: {bucket: (wav (N_b, sig_len_b) float16, ints (N_b,
        max_text_b + 4) int32)}, each row bit-identical to the wire row of
        ``_assemble_wav``. Sets ``corpus_row[dataset_idx] = (bucket, row)``
        for ``stream_indices``."""
        if not self.cfg.wav_transport:
            raise ValueError("device corpus requires data.wav_transport")
        corpora: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.corpus_row = {}
        for b, (spec, members) in enumerate(zip(self.buckets, self.bucket_members)):
            if not members:
                continue
            sig_len = (spec.max_frames - 1) * self.audio.hop_length + self.audio.n_fft
            wav = np.zeros((len(members), sig_len), WAV_WIRE_DTYPE)
            ints = np.zeros((len(members), spec.max_text + 4), np.int32)
            for row, idx in enumerate(sorted(members)):
                item = self.dataset.load(idx, wav_only=True)
                self._fill_wav_row(item, spec, wav[row], ints[row])
                self.corpus_row[idx] = (b, row)
            corpora[b] = (wav, ints)
        return corpora

    def stream_indices(self, start_batch: int = 0
                       ) -> Iterator[Tuple[int, np.ndarray, BucketSpec]]:
        """The deterministic batch stream of ``stream``, as (bucket, corpus
        row ids, bucket spec) for a batch gathered from the device corpus."""
        if self.corpus_row is None:
            raise RuntimeError(
                "stream_indices requires build_wav_corpus() first "
                "(it defines the dataset-index -> corpus-row map)")
        bpe = max(1, self.batches_per_epoch())
        epoch, skip = divmod(start_batch, bpe)
        while True:
            for indices, spec in self._epoch_batches(epoch)[skip:]:
                locs = [self.corpus_row[i] for i in indices]
                b = locs[0][0]
                if any(bb != b for bb, _ in locs):
                    raise RuntimeError("a batch spans two buckets")
                yield b, np.asarray([r for _, r in locs], np.int32), spec
            skip = 0
            epoch += 1

    # -- epoch plan -------------------------------------------------------------

    def _epoch_batches(self, epoch: int) -> List[Tuple[List[int], BucketSpec]]:
        """The epoch's batch plan. ``batch_size`` is the global batch: every
        host builds the same plan (same seed, permutation and shuffle) and
        takes its contiguous slice of each global batch, so the global stream
        is the same for any shard count and every host's plan has the same
        length."""
        if self.batch_size % self.num_shards:
            raise ValueError(f"global batch_size={self.batch_size} must divide by "
                             f"num_shards={self.num_shards}")
        per_host = self.batch_size // self.num_shards
        lo, hi = self.shard_index * per_host, (self.shard_index + 1) * per_host
        rng = np.random.default_rng((self.seed, epoch))
        plan: List[Tuple[List[int], BucketSpec]] = []
        for spec, members in zip(self.buckets, self.bucket_members):
            if not members:
                continue
            order = np.array(members)[rng.permutation(len(members))]
            for s in range(0, len(order), self.batch_size):
                chunk = order[s: s + self.batch_size].tolist()
                if len(chunk) < self.batch_size:
                    if self.drop_remainder:
                        continue
                    # wrap-around fill keeps the batch shape static
                    deficit = self.batch_size - len(chunk)
                    chunk = chunk + (order.tolist() * (
                        deficit // max(len(order), 1) + 1))[:deficit]
                plan.append((chunk, spec))
        rng.shuffle(plan)
        return [(chunk[lo:hi], spec) for chunk, spec in plan]

    # -- iteration --------------------------------------------------------------

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        for indices, spec in self._epoch_batches(epoch):
            yield self._assemble(indices, spec)

    def batches_per_epoch(self) -> int:
        """Constant across epochs (bucket member counts are fixed)."""
        return len(self._epoch_batches(0))

    def __iter__(self) -> Iterator[Batch]:
        return self.stream(0)

    def stream(self, start_batch: int = 0) -> Iterator[Batch]:
        """Infinite stream over epochs with background prefetch.
        ``start_batch`` resumes the deterministic stream at that batch."""
        bpe = max(1, self.batches_per_epoch())
        start_epoch, skip = divmod(start_batch, bpe)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def producer():
            epoch, to_skip = start_epoch, skip
            while not stop.is_set():
                plan = self._epoch_batches(epoch)[to_skip:]
                to_skip = 0
                for indices, spec in plan:
                    if stop.is_set():
                        return
                    out_q.put(self._assemble(indices, spec))
                epoch += 1

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                yield out_q.get()
        finally:
            stop.set()
            # drain so the producer can observe the stop flag
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass


def make_loader(pattern_dir: str, cfg: DataConfig, reduction_factor: int,
                **kwargs) -> BucketedLoader:
    return BucketedLoader(PatternDataset(pattern_dir, cfg.metadata_file), cfg,
                          reduction_factor, **kwargs)
