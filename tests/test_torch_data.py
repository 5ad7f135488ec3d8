"""The port's training-corpus path against the JAX package's, on the same
inputs: pattern generation (host numpy and device features with
``device="cpu"``), the corpus walkers and wav loading on tiny scipy-written
corpora, the bucketed loader in both transports and the device corpus, and
the wav-transport step's ``_materialize_features``.

Exact where the JAX package is numpy (metadata, tokens, wavs, epoch plans,
every loader batch bit for bit); features within 5e-4 normalized dB (the
contract of tests/test_device_features.py); the wav-transport features
within the budgets of tests/test_wav_transport.py (MAE < 1e-3, max 2e-2
mel and 1e-1 linear against the feature batch: the float16 wire)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from gst_tacotron_tpu.config import AudioConfig as JAudioConfig
from gst_tacotron_tpu.config import DataConfig as JDataConfig
from gst_tacotron_tpu.config import apply_overrides as japply
from gst_tacotron_tpu.config import get_preset as jpreset
from gst_tacotron_tpu.data import loader as jloader
from gst_tacotron_tpu.data import pattern as jpattern
from gst_tacotron_tpu.dsp import ref as jref
from gst_tacotron_tpu.train import _materialize_features as jmaterialize
from gst_tacotron_tpu_torch.config import AudioConfig, DataConfig, apply_overrides, get_preset
from gst_tacotron_tpu_torch.data import loader as tloader
from gst_tacotron_tpu_torch.data import pattern as tpattern
from gst_tacotron_tpu_torch.dsp import ref as tref
from gst_tacotron_tpu_torch.train import _materialize_features

torch.set_num_threads(2)

AUDIO = dict(n_fft=512, hop_length=128, win_length=512)
BUCKETS = ((64, 400), (128, 800), (192, 1200))


def _corpus(name):
    if name == "cycle":
        return tpattern.synthetic_utterances(6), jpattern.synthetic_utterances(6)
    kw = dict(num_speakers=2, variable=True, nonlinear_durations=True)
    return tpattern.synthetic_utterances(5, **kw), jpattern.synthetic_utterances(5, **kw)


def _read(path):
    with open(path) as f:
        return f.read()


def _assert_same_patterns(tdir, jdir, feat_atol):
    """Identical metadata JSON; equal tokens, texts, speaker ids and wavs;
    features within ``feat_atol``; the JAX dataset reads the port's files."""
    assert _read(os.path.join(tdir, "metadata.json")) == _read(os.path.join(jdir, "metadata.json"))
    tds, jds = jloader.PatternDataset(tdir), jloader.PatternDataset(jdir)
    assert len(tds) == len(jds) > 0
    for i in range(len(jds)):
        with np.load(os.path.join(tdir, tds.entries[i]["file"])) as t, \
                np.load(os.path.join(jdir, jds.entries[i]["file"])) as j:
            assert sorted(t.files) == sorted(j.files)
            for key in ("tokens", "speaker_id", "text", "wav"):
                assert t[key].dtype == j[key].dtype
                np.testing.assert_array_equal(t[key], j[key])
            for key in ("mel", "linear"):
                assert t[key].dtype == j[key].dtype == np.float32
                np.testing.assert_allclose(t[key], j[key], atol=feat_atol, rtol=0)


@pytest.mark.parametrize("corpus", ["cycle", "variable_nonlinear"])
def test_host_patterns_match_jax(tmp_path, corpus):
    tutts, jutts = _corpus(corpus)
    assert [u.__dict__ for u in tutts] == [u.__dict__ for u in jutts]
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tmeta = tpattern.generate_patterns(tutts, AudioConfig(**AUDIO), tdir, store_wav=True)
    jmeta = jpattern.generate_patterns(jutts, JAudioConfig(**AUDIO), jdir, store_wav=True)
    assert tmeta == jmeta
    # the host paths are the same float64 numpy arithmetic
    _assert_same_patterns(tdir, jdir, 0.0)


@pytest.mark.parametrize("corpus", ["cycle", "variable_nonlinear"])
def test_device_patterns_match_jax(tmp_path, corpus):
    """--device-features on the CPU: the port's default route (K3's plain
    version) against the JAX extractor's CPU path."""
    tutts, jutts = _corpus(corpus)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tpattern.generate_patterns(tutts, AudioConfig(**AUDIO), tdir, store_wav=True,
                               device_features=True, device="cpu")
    jpattern.generate_patterns(jutts, JAudioConfig(**AUDIO), jdir, store_wav=True,
                               device_features=True)
    _assert_same_patterns(tdir, jdir, 5e-4)


def test_wav_only_patterns_match_jax(tmp_path):
    tutts = tpattern.synthetic_utterances(4, variable=True)
    jutts = jpattern.synthetic_utterances(4, variable=True)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tpattern.generate_patterns(tutts, AudioConfig(**AUDIO), tdir, wav_only=True)
    jpattern.generate_patterns(jutts, JAudioConfig(**AUDIO), jdir, wav_only=True)
    assert _read(os.path.join(tdir, "metadata.json")) == _read(os.path.join(jdir, "metadata.json"))
    for e in json.loads(_read(os.path.join(tdir, "metadata.json")))["entries"]:
        with np.load(os.path.join(tdir, e["file"])) as t, np.load(os.path.join(jdir, e["file"])) as j:
            assert t["wav"].dtype == np.float16
            np.testing.assert_array_equal(t["wav"], j["wav"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpattern.generate_patterns(tutts, AudioConfig(**AUDIO), tdir, wav_only=True,
                                   device_features=True, device="cpu")


def test_pattern_and_loader_modules_import_no_torch():
    """The spawn workers of the host path unpickle ``extract_pattern``, which
    imports the data package: it must not pull in torch (nor CUDA)."""
    code = ("import sys\n"
            "import gst_tacotron_tpu_torch.data.pattern, gst_tacotron_tpu_torch.data.loader\n"
            "assert 'torch' not in sys.modules and 'jax' not in sys.modules\n"
            "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_worker_pool_matches_serial(tmp_path):
    """Two spawn workers (numpy only) write the serial path's patterns."""
    utts = tpattern.synthetic_utterances(4)
    audio = AudioConfig(**AUDIO)
    m1 = tpattern.generate_patterns(utts, audio, str(tmp_path / "a"))
    m2 = tpattern.generate_patterns(utts, audio, str(tmp_path / "b"), num_workers=2)
    assert m1 == m2


def _tone(sr, seconds, f0):
    t = np.arange(int(sr * seconds)) / sr
    return 0.4 * np.sin(2 * np.pi * f0 * t)


def test_walkers_and_wav_loading_match_jax(tmp_path):
    """LJSpeech and VCTK layouts written with scipy: int16 at a foreign rate,
    stereo, 44.1 kHz, int32 and float32 files; silence to trim at both ends."""
    lj = tmp_path / "lj"
    (lj / "wavs").mkdir(parents=True)
    rows = []
    for i in range(3):
        uid = f"LJ001-{i:04d}"
        sig = np.concatenate([np.zeros(6000), _tone(16000, 1.2, 200 + 40 * i), np.zeros(9000)])
        wavfile.write(str(lj / "wavs" / (uid + ".wav")), 16000, (sig * 32767).astype(np.int16))
        rows.append(f"{uid}|raw text {i}|" + (f"normalized text {i}." if i != 1 else ""))
    rows.append("malformed-row")
    (lj / "metadata.csv").write_text("\n".join(rows), encoding="utf-8")

    vctk = tmp_path / "vctk"
    for spk in ("p225", "p226"):
        (vctk / "txt" / spk).mkdir(parents=True)
        (vctk / "wav48" / spk).mkdir(parents=True)
        for j in range(2):
            uid = f"{spk}_{j:03d}"
            (vctk / "txt" / spk / (uid + ".txt")).write_text(f"sentence {j} for {spk}.\n")
            tone = _tone(44100, 0.8, 150 + 30 * j)
            if spk == "p225":     # stereo int16 at 44.1 kHz
                data = (np.stack([tone, 0.5 * tone], 1) * 32767).astype(np.int16)
            elif j == 0:          # int32
                data = (tone * 2 ** 31 * 0.9).astype(np.int32)
            else:                 # float32
                data = tone.astype(np.float32)
            wavfile.write(str(vctk / "wav48" / spk / (uid + ".wav")), 44100, data)
    (vctk / "txt" / "p225" / "p225_999.txt").write_text("orphan.")   # no wav: skipped

    for walk_t, walk_j, root, n in ((tpattern.walk_ljspeech, jpattern.walk_ljspeech, lj, 3),
                                    (tpattern.walk_vctk, jpattern.walk_vctk, vctk, 4)):
        tutts, jutts = walk_t(str(root)), walk_j(str(root))
        assert len(tutts) == n
        assert [u.__dict__ for u in tutts] == [u.__dict__ for u in jutts]
        for u in tutts:
            got = tpattern.load_wav(u.wav_path, 22050)
            ref = jpattern.load_wav(u.wav_path, 22050)
            assert got.dtype == np.float32 and got.ndim == 1
            np.testing.assert_array_equal(got, ref)
        tdir, jdir = str(tmp_path / f"t_{root.name}"), str(tmp_path / f"j_{root.name}")
        tpattern.generate_patterns(tutts, AudioConfig(**AUDIO), tdir, store_wav=True)
        jpattern.generate_patterns(jutts, JAudioConfig(**AUDIO), jdir, store_wav=True)
        _assert_same_patterns(tdir, jdir, 0.0)
    assert tpattern.walk_ljspeech(str(lj))[1].text == "raw text 1"
    assert {u.speaker_id for u in tpattern.walk_vctk(str(vctk))} == {0, 1}


def test_trim_silence_matches_jax():
    cfg, jcfg = AudioConfig(), JAudioConfig()
    rng = np.random.default_rng(0)
    sig = np.concatenate([1e-5 * rng.standard_normal(7000), _tone(22050, 0.5, 300),
                          1e-5 * rng.standard_normal(12000)]).astype(np.float32)
    got = tref.trim_silence(sig, cfg)
    assert 0 < len(got) < len(sig)
    np.testing.assert_array_equal(got, jref.trim_silence(sig, jcfg))
    for short_or_silent in (sig[:1000], np.zeros(5000, np.float32)):
        np.testing.assert_array_equal(tref.trim_silence(short_or_silent, cfg),
                                      jref.trim_silence(short_or_silent, jcfg))


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """A variable-length corpus that fills all three buckets, with wavs."""
    out = str(tmp_path_factory.mktemp("corpus"))
    utts = tpattern.synthetic_utterances(20, num_speakers=2, variable=True)
    tpattern.generate_patterns(utts, AudioConfig(**AUDIO), out, store_wav=True)
    return out


def _data_cfgs(**kw):
    base = dict(batch_size=3, buckets=BUCKETS, prefetch=2)
    base.update(kw)
    return DataConfig(**base), JDataConfig(**base)


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("wav_transport", [False, True])
@pytest.mark.parametrize("shards", [1, 3])
def test_loader_batches_match_jax_bit_for_bit(corpus_dir, wav_transport, shards):
    tcfg, jcfg = _data_cfgs(wav_transport=wav_transport)
    tds, jds = tloader.PatternDataset(corpus_dir), jloader.PatternDataset(corpus_dir)
    for shard in range(shards):
        kw = dict(seed=9, shard_index=shard, num_shards=shards)
        tl = tloader.BucketedLoader(tds, tcfg, 2, audio_cfg=AudioConfig(**AUDIO), **kw)
        jl = jloader.BucketedLoader(jds, jcfg, 2, audio_cfg=JAudioConfig(**AUDIO), **kw)
        assert [len(m) for m in tl.bucket_members] == [len(m) for m in jl.bucket_members]
        assert all(len(m) for m in tl.bucket_members)
        for epoch in (0, 1):
            tp, jp = tl._epoch_batches(epoch), jl._epoch_batches(epoch)
            assert [(c, s.__dict__) for c, s in tp] == [(c, s.__dict__) for c, s in jp]
        assert tl.batches_per_epoch() == jl.batches_per_epoch() > 0
        for a, b in zip(tl.epoch(0), jl.epoch(0)):
            _assert_batches_equal(a, b)


def test_loader_stream_and_remainder_match_jax(corpus_dir):
    """The prefetching stream, resumed mid-epoch, with wrap-around fill."""
    tcfg, jcfg = _data_cfgs(wav_transport=True)
    tl = tloader.BucketedLoader(tloader.PatternDataset(corpus_dir), tcfg, 2, seed=2,
                                drop_remainder=False, audio_cfg=AudioConfig(**AUDIO))
    jl = jloader.BucketedLoader(jloader.PatternDataset(corpus_dir), jcfg, 2, seed=2,
                                drop_remainder=False, audio_cfg=JAudioConfig(**AUDIO))
    k = tl.batches_per_epoch() + 1
    ts, js = tl.stream(start_batch=k), jl.stream(start_batch=k)
    for _ in range(3):
        _assert_batches_equal(next(ts), next(js))
    ts.close()
    js.close()


def test_wav_corpus_and_stream_indices_match_jax(corpus_dir):
    tcfg, jcfg = _data_cfgs(wav_transport=True)
    tl = tloader.BucketedLoader(tloader.PatternDataset(corpus_dir), tcfg, 2, seed=4,
                                audio_cfg=AudioConfig(**AUDIO))
    jl = jloader.BucketedLoader(jloader.PatternDataset(corpus_dir), jcfg, 2, seed=4,
                                audio_cfg=JAudioConfig(**AUDIO))
    with pytest.raises(RuntimeError, match="build_wav_corpus"):
        next(tl.stream_indices())
    tc, jc = tl.build_wav_corpus(), jl.build_wav_corpus()
    assert tc.keys() == jc.keys() and tl.corpus_row == jl.corpus_row
    for b in tc:
        for x, y in zip(tc[b], jc[b]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    ti, ji = tl.stream_indices(1), jl.stream_indices(1)
    wire = tl.stream(1)
    for _ in range(tl.batches_per_epoch() + 1):
        (tb, trows, tspec), (jb, jrows, jspec) = next(ti), next(ji)
        assert tb == jb and tspec.__dict__ == jspec.__dict__
        np.testing.assert_array_equal(trows, jrows)
        batch = next(wire)
        # the corpus rows are the wire rows
        np.testing.assert_array_equal(tc[tb][0][trows], batch["wav"])
        np.testing.assert_array_equal(tc[tb][1][trows], batch["ints"])
    wire.close()


def test_loader_error_cases(tmp_path, corpus_dir):
    """tests/test_wav_transport.py:148-152 and the other refusals."""
    audio = AudioConfig(**AUDIO)
    nowav = str(tmp_path / "nowav")
    tpattern.generate_patterns(tpattern.synthetic_utterances(3), audio, nowav)
    wav_cfg, _ = _data_cfgs(wav_transport=True)
    feat_cfg, _ = _data_cfgs()
    with pytest.raises(ValueError, match="store-wav"):
        tloader.BucketedLoader(tloader.PatternDataset(nowav), wav_cfg, 2, audio_cfg=audio)
    with pytest.raises(ValueError, match="audio_cfg"):
        tloader.BucketedLoader(tloader.PatternDataset(corpus_dir), wav_cfg, 2)
    wavonly = str(tmp_path / "wavonly")
    tpattern.generate_patterns(tpattern.synthetic_utterances(3), audio, wavonly, wav_only=True)
    with pytest.raises(ValueError, match="wav-only"):
        tloader.BucketedLoader(tloader.PatternDataset(wavonly), feat_cfg, 2)
    with pytest.raises(ValueError, match="wav_transport"):
        tloader.BucketedLoader(tloader.PatternDataset(corpus_dir), feat_cfg, 2).build_wav_corpus()
    with pytest.raises(ValueError, match="must divide"):
        tloader.BucketedLoader(tloader.PatternDataset(corpus_dir), feat_cfg, 2,
                               num_shards=2)._epoch_batches(0)
    tiny, _ = _data_cfgs(buckets=((8, 16),), batch_size=1)
    small = tloader.BucketedLoader(tloader.PatternDataset(corpus_dir), tiny, 2)
    assert small.dropped_overflow == 20 and small.batches_per_epoch() == 0


def test_entry_split_and_make_loader_match_jax(corpus_dir):
    for uid in ("synth_00000", "LJ001-0001", "p225_003"):
        for frac in (0.0, 0.05, 0.5):
            assert tloader.entry_split(uid, frac) == jloader.entry_split(uid, frac)
    tcfg, jcfg = _data_cfgs(val_fraction=0.3)
    tv = tloader.make_loader(corpus_dir, tcfg, 2, split="val")
    jv = jloader.make_loader(corpus_dir, jcfg, 2, split="val")
    assert tv.bucket_members == jv.bucket_members and tv.other_split == jv.other_split > 0


def _wav_batch_pair(corpus_dir):
    cfg = apply_overrides(get_preset("gst_lj"), {
        **{f"audio.{k}": v for k, v in AUDIO.items()}, "model.num_freq": 257,
        "data.batch_size": 3, "data.wav_transport": True})
    feat = tloader.BucketedLoader(tloader.PatternDataset(corpus_dir),
                                  apply_overrides(cfg, {"data.wav_transport": False}).data,
                                  2, seed=5)
    wav = tloader.BucketedLoader(tloader.PatternDataset(corpus_dir), cfg.data, 2, seed=5,
                                 audio_cfg=cfg.audio)
    return cfg, next(iter(feat.epoch(0))), next(iter(wav.epoch(0)))


def test_materialize_features_matches_jax_and_feature_batch(corpus_dir):
    cfg, fb, wb = _wav_batch_pair(corpus_dir)
    jcfg = japply(jpreset("gst_lj"), {
        **{f"audio.{k}": v for k, v in AUDIO.items()}, "model.num_freq": 257})
    mat = _materialize_features(cfg, {k: torch.from_numpy(v) for k, v in wb.items()})
    jmat = jmaterialize(jcfg, {k: jnp.asarray(v) for k, v in wb.items()})
    assert mat.keys() == jmat.keys()
    for k in ("tokens", "token_lengths", "mel_lengths", "speaker_ids"):
        np.testing.assert_array_equal(mat[k].numpy(), np.asarray(jmat[k]))
        np.testing.assert_array_equal(mat[k].numpy(), fb[k])
    for k in ("mel", "linear"):
        np.testing.assert_allclose(mat[k].numpy(), np.asarray(jmat[k]), atol=5e-4, rtol=0)
    t = fb["mel"].shape[1]
    for name, mxtol in (("mel", 2e-2), ("linear", 1e-1)):
        dev = mat[name].numpy()
        assert dev.shape[1] >= t
        err = np.abs(dev[:, :t] - fb[name])
        assert err.mean() < 1e-3, f"{name} MAE {err.mean()}"
        assert err.max() < mxtol, f"{name} max err {err.max()}"
    frames_true = wb["ints"][:, -2]
    for j in range(len(frames_true)):
        assert np.all(mat["mel"].numpy()[j, frames_true[j]:] == 0.0)
        assert np.all(mat["linear"].numpy()[j, frames_true[j]:] == 0.0)
    assert _materialize_features(cfg, fb) is fb
