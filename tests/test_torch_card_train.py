"""The port's training path and what runs on a trained workdir, on the card:

* ``Trainer`` at gst_lj's published widths (batch 8) over a synthetic
  corpus whose features came through K3: no step launches a kernel, every
  parameter has a gradient at step 1, the losses are finite; the eval hook
  synthesizes (K1, K4) and the held-out eval logs a finite loss; a second
  ``Trainer`` restores the checkpoint bit for bit; two steps on the wav
  transport with the corpus on the card launch nothing either; synthesis
  from the trained state gives the gst_lj path's launch counts;
* one step at the CPU tests' widths on the card against the same step on
  the CPU (gst_lj, and with its Taco2 encoder);
* ``VocoderTrainer`` on gst_wavernn's WaveRNN: no launch, finite losses, a
  restore bit for bit;
* same-seed training bit for bit with the step's CUDA graph replayed, and
  another seed apart;
* one ``model.compute_dtype="bfloat16"`` step;
* the synthesize CLI (Griffin-Lim, the chunked decoder, the WaveRNN
  vocoder) and the style-contrast report on the trained workdirs;
* world size 1 over NCCL, then two ranks on the one card over gloo
  (``tests/torch_dist_workers.py::card_ranks``): data- and tensor-parallel
  synthesis, training and sampling against the single process.

Needs an NVIDIA GPU and nvcc; skipped without a card. Imports no JAX, so
it runs on the GPU machine with ``--noconftest`` (tests/test_torch_cuda.py
gives the card command).
"""

import contextlib
import copy
import io
import json
import os

import numpy as np
import pytest
import torch

# by their own names, from tests/ on the path: where JAX is absent, an
# installed package may own the name ``tests``
from test_torch_card_paths import GST_LAUNCHES, inputs, launched
from test_torch_cuda import dev  # noqa: F401 (the card fixture)
from test_torch_train_graph import make_batch

pytestmark = pytest.mark.cuda

TRAIN_BATCH = 8
TRAIN_STEPS = 6
CORPUS_UTTERANCES = 48
# tests/test_train_smoke.py::small_cfg's widths (the CPU tests' sizes)
SMALL_WIDTHS = {
    "audio.n_fft": 512, "audio.hop_length": 128, "audio.win_length": 512,
    "model.num_freq": 257, "model.encoder.embedding_dim": 32,
    "model.encoder.prenet_dims": [32, 16], "model.encoder.cbhg_bank_k": 4,
    "model.encoder.cbhg_bank_channels": 16, "model.encoder.cbhg_proj_channels": [16, 16],
    "model.encoder.cbhg_highway_layers": 2, "model.encoder.cbhg_highway_dim": 16,
    "model.encoder.cbhg_gru_dim": 16, "model.gst.ref_conv_channels": [4, 8, 16],
    "model.gst.ref_gru_dim": 16, "model.gst.style_dim": 16, "model.attention.dim": 16,
    "model.decoder.prenet_dims": [32, 16], "model.decoder.attention_rnn_dim": 16,
    "model.decoder.decoder_rnn_dim": 16, "model.postnet.cbhg_bank_k": 2,
    "model.postnet.cbhg_bank_channels": 8, "model.postnet.cbhg_proj_channels": [16, 80],
    "model.postnet.cbhg_highway_layers": 1, "model.postnet.cbhg_highway_dim": 16,
    "model.postnet.cbhg_gru_dim": 16}


def gst_lj(overrides=None):
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset

    return apply_overrides(get_preset("gst_lj"), {"data.batch_size": TRAIN_BATCH,
                                                  **(overrides or {})})


@pytest.fixture(scope="module")
def corpus(dev, tmp_path_factory):
    """A varied synthetic corpus at gst_lj's audio, wavs kept, features
    through K3 (float32 by name); every bucket fills a batch."""
    from gst_tacotron_tpu_torch.data import generate_patterns, synthetic_utterances

    out = str(tmp_path_factory.mktemp("corpus"))
    generate_patterns(synthetic_utterances(CORPUS_UTTERANCES, variable=True), gst_lj().audio,
                      out, store_wav=True, device_features=True, device=dev, bf16=False)
    return out


def same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture(scope="module")
def trained(dev, corpus, tmp_path_factory):
    """The feature transport's ``TRAIN_STEPS`` steps (a checkpoint at step
    4, the held-out eval and ``default_eval_hook`` at the last), the launch
    counters read after each step and around the hook; a second trainer
    restoring the last checkpoint; two steps on the wav transport with the
    corpus on the card. The workdir stays for the CLI and style tests."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides
    from gst_tacotron_tpu_torch.train import Trainer, default_eval_hook

    work = str(tmp_path_factory.mktemp("train"))
    cfg = gst_lj({"train.checkpoint_every": 4, "train.eval_every": TRAIN_STEPS,
                  "train.log_every": 1})
    rec = {"step_launches": [], "losses": [], "eval_launches": None, "no_grad": None}

    def on_step(tr, step, metrics, frames):
        rec["step_launches"].append(launched())
        rec["losses"] += [float(v) for k, v in metrics.items() if k.endswith("loss")]
        if step == 1:
            rec["no_grad"] = [k for k, p in tr.state.model.named_parameters()
                              if p.grad is None or not bool(p.grad.abs().max() > 0)]

    def hook(tr, step):
        ops.reset_launch_counts()
        default_eval_hook(tr, step)
        rec["eval_launches"] = launched()
        ops.reset_launch_counts()

    ops.reset_launch_counts()
    trainer = Trainer(cfg, corpus, f"{work}/feat", device=dev)
    trainer.train(TRAIN_STEPS, eval_fn=hook, on_step=on_step)
    with open(f"{work}/feat/logs/metrics.jsonl") as f:
        rec["log"] = [json.loads(line) for line in f]
    again = Trainer(cfg, corpus, f"{work}/feat", device=dev)
    opt, opt2 = trainer.state.opt, again.state.opt
    rec["restored"] = (again.restore_if_available() and again.state.step == TRAIN_STEPS
                       and same_state(trainer.state.model, again.state.model)
                       and all(torch.equal(opt.mu[k], opt2.mu[k])
                               and torch.equal(opt.nu[k], opt2.nu[k]) for k in opt.mu))
    wire = Trainer(apply_overrides(cfg, {"data.wav_transport": True, "data.device_corpus": True}),
                   corpus, f"{work}/wire", device=dev)
    ops.reset_launch_counts()
    wire.train(2, on_step=on_step)
    return {**rec, "work": work, "cfg": cfg, "model": trainer.state.model}


def test_train_steps_launch_no_kernel(trained):
    assert len(trained["step_launches"]) == TRAIN_STEPS + 2
    assert all(not counts for counts in trained["step_launches"]), trained["step_launches"]
    assert trained["no_grad"] == []
    assert trained["losses"] and all(np.isfinite(trained["losses"]))


def test_eval_hook_and_held_out_eval_on_the_card(trained):
    launches = trained["eval_launches"]
    assert launches.get("gru_scan") and launches.get("decode_scan"), launches
    log = trained["log"]
    assert any(r["step"] == TRAIN_STEPS and "eval/diagonality" in r for r in log)
    assert not any("eval/eval_error" in r for r in log)
    assert any("eval/eval_loss" in r and np.isfinite(r["eval/eval_loss"]) for r in log)


def test_restore_is_bit_for_bit(trained):
    assert trained["restored"]


def test_synthesis_from_the_trained_state(dev, trained):
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.synthesize import Synthesizer

    cfg = trained["cfg"]
    texts, wavs = inputs(9, cfg.audio.sample_rate)
    ops.reset_launch_counts()
    out = Synthesizer(cfg, trained["model"], device=dev)(texts, reference_wavs=wavs,
                                                         max_steps=32)
    assert launched() == {**GST_LAUNCHES, "griffin_lim": cfg.audio.griffin_lim_iters}
    assert all(np.all(np.isfinite(out[k])) for k in ("mel", "linear", "wav"))


@pytest.mark.parametrize("encoder", ["taco1", "taco2"])
def test_card_step_matches_a_cpu_step(dev, encoder):
    """One train step of gst_lj at the CPU tests' widths (prenet dropout
    off, tests/test_torch_train_parity.py's constant schedule at lr 1e-3)
    on the card (TF32 off) and on the CPU from the same weights and batch:
    the losses within 1e-5 relative, the parameters within 1e-5, each
    gradient within 1e-4 of its largest |g|."""
    from gst_tacotron_tpu_torch.train import TrainState, make_optimizer, train_step
    from gst_tacotron_tpu_torch.weights import build_model

    cfg = gst_lj({**SMALL_WIDTHS, "model.encoder.kind": encoder,
                  "model.encoder.prenet_dropout": 0.0, "model.decoder.prenet_dropout": 0.0,
                  "optimizer.schedule": "constant", "optimizer.learning_rate": 1e-3})
    batch = make_batch(np.random.default_rng(11), cfg.model.num_freq, b=4, t_text=24, t_mel=64)
    cpu_model = build_model(cfg, seed=5, device="cpu")
    if hasattr(cpu_model.encoder, "convs"):
        # the card's and the CPU's generators draw different masks
        cpu_model.encoder.convs.dropout_rate = 0.0
    res = {}
    for d, model in (("cpu", cpu_model), (dev, copy.deepcopy(cpu_model).to(dev))):
        tx = make_optimizer(cfg.optimizer)
        st = TrainState(0, model, tx.init(dict(model.named_parameters())), 0)
        m = train_step(tx, cfg, st, {k: torch.from_numpy(v).to(d) for k, v in batch.items()})
        res[str(d)] = ({k: float(v) for k, v in m.items()},
                       {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                       {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (mc, gc, pc), (mg, gg, pg) = res["cpu"], res[str(dev)]
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-5 * max(abs(mc[k]), 1e-30), k
    for k in gc:
        assert float((gg[k] - gc[k]).abs().max()) <= 1e-4 * max(float(gc[k].abs().max()),
                                                                1e-30), k
    for k in pc:
        assert float((pg[k] - pc[k]).abs().max()) <= 1e-5, k


@pytest.fixture(scope="module")
def vocoder(dev, corpus, tmp_path_factory):
    """gst_wavernn's WaveRNN at its widths: two ``VocoderTrainer`` steps of
    8 x 24 frames over the corpus (a checkpoint at step 2), the launch
    counters read after each, then a second trainer restoring it. The
    workdir stays for the CLI test."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
    from gst_tacotron_tpu_torch.vocoder_train import VocoderTrainer

    work = str(tmp_path_factory.mktemp("vocoder"))
    cfg = apply_overrides(get_preset("gst_wavernn"), {"train.log_every": 1,
                                                      "train.checkpoint_every": 2})
    vt = VocoderTrainer(cfg, corpus, work, device=dev, segment_frames=24, batch_size=8)
    ops.reset_launch_counts()
    step_launches = []
    for step in (1, 2):
        vt.train(step)
        step_launches.append(launched())
    with open(f"{work}/vocoder_logs/metrics.jsonl") as f:
        losses = [json.loads(line)["vocoder/loss"] for line in f]
    again = VocoderTrainer(cfg, corpus, work, device=dev, segment_frames=24, batch_size=8)
    restored = (again.restore_if_available() and again.state.step == 2
                and same_state(vt.model, again.model))
    return {"work": work, "step_launches": step_launches, "losses": losses,
            "restored": restored}


def test_vocoder_trainer_on_the_card(vocoder):
    assert vocoder["step_launches"] == [{}, {}]
    assert len(vocoder["losses"]) == 2 and all(np.isfinite(vocoder["losses"]))
    assert vocoder["restored"]


def test_same_seed_training_is_bitwise_with_the_graph_replayed(dev, corpus, tmp_path):
    """tests/test_determinism.py's contract on the card at gst_lj's widths:
    two ``Trainer`` runs of seed 7, four steps of one padded shape each (the
    first eager, the second captured as a CUDA graph, the graph replayed
    from then on), agree in every bit of every parameter, buffer and Adam
    moment; seed 8 differs."""
    from gst_tacotron_tpu_torch.config import apply_overrides
    from gst_tacotron_tpu_torch.train import Trainer
    from gst_tacotron_tpu_torch.utils.profiling import counters

    cfg = gst_lj({"data.buckets": [[192, 1200]], "train.log_every": 10 ** 6,
                  "train.checkpoint_every": 10 ** 7, "train.eval_every": 10 ** 8})
    states, replays = [], []
    for i, seed in enumerate((7, 7, 8)):
        before = counters().get("train_graph_replays", 0)
        state = Trainer(apply_overrides(cfg, {"train.seed": seed}), corpus,
                        str(tmp_path / f"run{i}"), device=dev).train(4)
        replays.append(counters().get("train_graph_replays", 0) - before)
        states.append({**{f"model/{k}": v.detach().cpu().clone()
                          for k, v in state.model.state_dict().items()},
                       **{f"mu/{k}": v.cpu().clone() for k, v in state.opt.mu.items()},
                       **{f"nu/{k}": v.cpu().clone() for k, v in state.opt.nu.items()}})
        del state
    assert replays[0] == replays[1] >= 2
    assert [k for k in states[0] if not torch.equal(states[0][k], states[1][k])] == []
    assert any(not torch.equal(states[0][k], states[2][k]) for k in states[0])


def test_bf16_trainer_step_on_the_card(dev, corpus, tmp_path):
    """One ``Trainer`` step at ``model.compute_dtype="bfloat16"``, gst_lj's
    widths: a finite loss, the parameters still float32."""
    from gst_tacotron_tpu_torch.train import Trainer

    trainer = Trainer(gst_lj({"model.compute_dtype": "bfloat16"}), corpus, str(tmp_path),
                      device=dev)
    metrics = trainer.step_batch(next(iter(trainer.loader.epoch(0))))
    assert np.isfinite(float(metrics["loss"]))
    assert all(p.dtype == torch.float32 for p in trainer.state.model.parameters())


def test_cli_on_the_trained_workdirs(trained, vocoder, tmp_path):
    """``synthesize.main`` on the trained workdir, decode cut to 16 steps:
    Griffin-Lim with two reference wavs, the chunked decoder, and the
    WaveRNN vocoder from its workdir; each writes a wav (and, where
    matplotlib imports, an alignment PNG) a text, and the three runs
    launch K1-K5 between them."""
    from scipy.io import wavfile

    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.synthesize import main as synthesize_main

    sr = trained["cfg"].audio.sample_rate
    texts, wavs = inputs(21, sr, b=2)
    refs = [str(tmp_path / f"ref_{i}.wav") for i in range(2)]
    for path, w in zip(refs, wavs):
        wavfile.write(path, sr, (w * 32767).astype(np.int16))
    try:
        import matplotlib  # noqa: F401
        pngs = 2
    except ImportError:
        pngs = 0
    runs = {"griffin_lim": ["--reference-wavs", *refs],
            "chunked": ["--reference-wavs", *refs, "--chunked-decoder"],
            "wavernn": ["--vocoder", "wavernn", "--vocoder-workdir", vocoder["work"]]}
    seen = {}
    for label, extra in runs.items():
        out = str(tmp_path / label)
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            synthesize_main(["--workdir", f"{trained['work']}/feat", "--out", out,
                             "model.decoder.max_decode_steps=16", *extra, "--texts", *texts])
        for k, n in launched().items():
            seen[k] = seen.get(k, 0) + n
        names = os.listdir(out)
        assert sum(n.endswith(".wav") for n in names) == 2, (label, names)
        assert sum(n.endswith("_align.png") for n in names) == pngs, (label, names)
    assert all(seen.get(k) for k in ("gru_scan", "refenc_stack", "stft_features", "decode_scan",
                                     "wavernn_sample")), seen


def test_style_contrast_on_the_trained_workdir(trained, tmp_path):
    """``style_contrast.main`` on the trained gst_lj workdir: every
    condition reported, the deterministic pass's bits the same under two
    seeds, no two one-hot conditions with the same mel, K1-K4 launched."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.style_contrast import main as style_main

    ops.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        report = style_main(["--workdir", f"{trained['work']}/feat",
                             "--out", str(tmp_path / "style.json")])
    counts = launched()
    det = report["deterministic_pass"]
    assert report["conditions"] == sorted(["token0", "token3", "token5", "token7", "uniform",
                                           "ref_wav"])
    assert det["seed_floor_bit_identical"], det["seed_floor_mel_l1"]
    onehot = [v["mel_l1"] for k, v in det["pairwise"].items()
              if all(n.startswith("token") for n in k.split("|"))]
    assert len(onehot) == 6 and min(onehot) > 0
    assert all(counts.get(k) for k in ("gru_scan", "refenc_stack", "stft_features",
                                       "decode_scan")), counts


def test_world_size_one_and_two_ranks_on_one_card(dev):
    """gst_lj at the CPU tests' widths, 8 texts with reference wavs, 16
    decode steps (chunks of 8), stop threshold 1.0. World size 1 over NCCL:
    ``DistributedSynthesizer`` gives the ``Synthesizer``'s bits and a train
    step under the (1, 1) mesh the unmeshed loss. Two ranks on this card
    over gloo: dp=2 synthesis within 1e-5 of the single process, its
    chunked path's ``chunks_run`` the single process's at stop thresholds
    1.0 and 0.0; dp=2 and tp=2 steps within 1e-5 (relative) of the single
    loss, the tp=2 ranks' replicated parameters and buffers bit-equal after
    four steps; gst_wavernn's K5 at dp=2 the single process's classes; every
    rank launching K1-K5."""
    import torch.distributed as dist

    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
    from gst_tacotron_tpu_torch.parallel import DistributedSynthesizer, make_mesh
    from gst_tacotron_tpu_torch.parallel.mesh import free_port
    from gst_tacotron_tpu_torch.synthesize import Synthesizer
    from gst_tacotron_tpu_torch.weights import build_model, build_wavernn

    from torch_dist_workers import card_train, run_ranks

    cfg = gst_lj({**SMALL_WIDTHS, "model.decoder.max_decode_steps": 16,
                  "audio.griffin_lim_iters": 2, "model.decoder.stop_threshold": 1.0})
    cfg5 = get_preset("gst_wavernn")
    b, chunk = 8, 8
    rng = np.random.default_rng(21)
    texts, wavs = inputs(21, cfg.audio.sample_rate, b=b)
    batch = make_batch(rng, cfg.model.num_freq, b=b, t_text=24, t_mel=64)
    mel5 = rng.uniform(0, 1, (b, 8, cfg5.model.num_mels)).astype(np.float32)

    model = build_model(cfg, seed=0, device=dev)
    ref = Synthesizer(cfg, model, device=dev)(texts, reference_wavs=wavs, seed=5)
    ref_chunks = {}
    for t in (1.0, 0.0):
        c = apply_overrides(cfg, {"model.decoder.stop_threshold": t})
        ref_chunks[t] = Synthesizer(c, build_model(c, seed=0, device=dev), device=dev,
                                    use_chunked_decoder=True, chunk_steps=chunk)(
            texts, reference_wavs=wavs, seed=5)["chunks_run"]
    ref_loss = card_train(cfg, dev, batch)[0]
    with torch.no_grad():
        ref_classes = build_wavernn(cfg5, seed=1, device=dev).sample_classes(
            torch.from_numpy(mel5).to(dev), seed=9).cpu().numpy()

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        got = DistributedSynthesizer(cfg, model, mesh, device=dev).synthesize(
            texts, reference_wavs=wavs, seed=5)
        meshed_loss = card_train(cfg, dev, batch, mesh)[0]
    finally:
        dist.destroy_process_group()
    for k in ("mel", "linear", "stop_logits", "alignments", "wav"):
        assert np.array_equal(got[k], ref[k]), k
    assert meshed_loss == ref_loss

    ranks = run_ranks("card_ranks", 2, cfg, cfg5, (texts, wavs, batch, mel5), str(dev), chunk, 4,
                      timeout=600)
    for r in ranks:
        assert float(np.abs(r["mel"] - ref["mel"]).max()) <= 1e-5
        assert r["chunks_run"] == ref_chunks
        for k in ("dp", "tp"):
            assert abs(r["losses"][k] - ref_loss) <= 1e-5 * abs(ref_loss), k
        assert np.array_equal(r["classes"], ref_classes)
        assert all(r["launches"].get(k) for k in ("gru_scan", "refenc_stack", "stft_features",
                                                  "decode_scan", "wavernn_sample")), r["launches"]
    assert ranks[0]["digests"] == ranks[1]["digests"]
