"""JAX workdirs exported into the port (``tools/export_jax_workdir.py``) on
the CPU. A tiny gst_lj state (tools/make_jax_export_fixture.py's config:
small_cfg's widths, prenet dropout 0, the constant schedule at lr 1e-3) is
trained two steps by the JAX ``Trainer``, as tests/test_train_smoke.py
does (from the port's seeded initial weights, for time), and exported;
then:

* the export holds the orbax state's arrays exactly (variables, Adam's
  moments and counts, the step) and ``checkpoint.read_jax_export`` lays
  them out as ``train.state_dict`` does;
* the port's ``Synthesizer`` on the exported workdir against the JAX
  ``Synthesizer`` restored from the orbax workdir, ``deterministic_prenet=
  True``: the golden gate's budgets (mel MAE < 1e-4, allclose 1e-3, MCD <
  0.1 dB, equal frame lengths), and the synthesize CLI writes its wavs from
  it;
* the port's ``Trainer`` resumed from the export takes step 3 as the JAX
  ``Trainer`` resumed from orbax does: each loss term within 1e-5
  relative (``grad_norm`` 1e-4), then the parameters within 5e-5 and the batch statistics
  within 1e-5 of each tensor's largest (tests/test_torch_train_parity.py's
  budgets);
* a JAX ``VocoderTrainer`` workdir (gst_wavernn at small widths, 2 steps)
  exported with ``--vocoder``: ``vocoder.load_wavernn_variables`` gives the
  orbax parameters exactly, the greedy sampler on them gives JAX's samples
  (1e-6), and the port's ``VocoderTrainer`` resumed from the export takes
  the next step on a batch as JAX's does (loss 1e-5 relative, parameters
  5e-5);
* the committed fixture (tests/fixtures/jax_export) still holds what the
  JAX package computes from it: the port's mel within 1e-4 MAE of its
  stored JAX mel, and its resumed step within 1e-5 relative of the stored
  losses.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gst_tacotron_tpu.config import apply_overrides as japply
from gst_tacotron_tpu.train import build_model as jbuild
from gst_tacotron_tpu_torch.checkpoint import CheckpointManager, read_jax_export
from gst_tacotron_tpu_torch.config import load_config
from gst_tacotron_tpu_torch.data import generate_patterns, synthetic_utterances
from gst_tacotron_tpu_torch.synthesize import Synthesizer
from gst_tacotron_tpu_torch.synthesize import main as synthesize_main
from gst_tacotron_tpu_torch.train import Trainer
from gst_tacotron_tpu_torch.vocoder import WaveRNNVocoder, load_wavernn_variables
from gst_tacotron_tpu_torch.vocoder_train import VocoderTrainer
from gst_tacotron_tpu_torch.weights import build_model, build_wavernn, export_flat

from tests.test_torch_synth_configs import flatten_tree

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "tools"))
from export_jax_workdir import export  # noqa: E402
from make_jax_export_fixture import (TEXTS, fixture_config, jax_reference,  # noqa: E402
                                     make_patterns, reference_wav, train_workdir)

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "jax_export")


def port_patterns(cfg, out):
    """The port's copy of the fixture's corpus (both packages generate it
    alike)."""
    generate_patterns(synthetic_utterances(8, num_speakers=1), cfg.audio, out, store_wav=True)
    return out


def assert_step_matches(logged, ref):
    """A logged train step against the JAX one: the loss terms 1e-5
    relative, ``grad_norm`` 1e-4 (tests/test_torch_train_parity.py's step
    budget for it)."""
    for name, want in zip(ref["next_loss_names"], ref["next_losses"]):
        rtol = 1e-4 if name == "grad_norm" else 1e-5
        np.testing.assert_allclose(logged[f"train/{name}"], want, rtol=rtol, err_msg=str(name))


def port_seeded_init_state(cfg, rng, sample):
    """``train.init_state`` with the initial variables drawn by the port's
    seeded init (``weights.build_model(seed=)``) in place of flax's: the
    same tree, shapes and dtypes, built with no JAX compile (flax's init
    costs 11 s here under ``jax.jit``, most of a minute eagerly). What the
    export is held to starts after it: two JAX ``Trainer`` steps from these
    weights."""
    import tempfile

    from gst_tacotron_tpu.config import save_config
    from gst_tacotron_tpu.train import TrainState, make_optimizer

    with tempfile.TemporaryDirectory() as d:
        save_config(cfg, f"{d}/config.json")
        pcfg = load_config(f"{d}/config.json")
    tree = {}
    for key, value in export_flat(build_model(pcfg, seed=cfg.train.seed, device="cpu")).items():
        *path, leaf = key.split("/")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = jnp.asarray(value)
    params = tree["params"]
    state_rng = jax.random.split(rng, 3)[2]
    return jbuild(cfg), TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   batch_stats=tree.get("batch_stats", {}),
                                   opt_state=make_optimizer(cfg.optimizer).init(params),
                                   rng=state_rng)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX run: 2 steps, the export, then (restored from orbax) the
    JAX ``Synthesizer``'s outputs and the next step."""
    import gst_tacotron_tpu.train as jtrain

    tmp = tmp_path_factory.mktemp("jax")
    cfg = fixture_config()
    patterns = make_patterns(cfg, str(tmp / "patterns"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "init_state", port_seeded_init_state)
        trainer = train_workdir(cfg, patterns, str(tmp / "work"))
    saved = jax.device_get(trainer.state)
    path = export(trainer.work_dir, str(tmp / "export"))
    ref = jax_reference(cfg, trainer)
    return {"cfg": cfg, "saved": saved, "npz": path, "out": str(tmp / "export"), "ref": ref}


def test_export_holds_the_orbax_state(jax_run):
    saved = jax_run["saved"]
    with np.load(jax_run["npz"]) as z:
        arrays = {k: z[k] for k in z.files}
    adam = saved.opt_state[1]
    assert isinstance(adam, optax.ScaleByAdamState)
    want = {**flatten_tree({"params": saved.params, "batch_stats": saved.batch_stats}),
            **{f"opt/{k}": v for k, v in flatten_tree({"mu": adam.mu, "nu": adam.nu}).items()}}
    assert set(arrays) == set(want) | {"opt/count", "opt/schedule_count", "step"}
    for k, v in want.items():
        np.testing.assert_array_equal(arrays[k], np.asarray(v), err_msg=k)
    assert int(arrays["step"]) == int(arrays["opt/count"]) == 2
    assert int(arrays["opt/schedule_count"]) == 2
    assert os.path.exists(os.path.join(jax_run["out"], "config.json"))
    state = read_jax_export(jax_run["npz"])
    cfg = load_config(os.path.join(jax_run["out"], "config.json"))
    model = build_model(cfg, seed=0, device="cpu")
    model.load_state_dict(state["model"])
    assert state["opt"]["mu"].keys() == dict(model.named_parameters()).keys()
    assert state["step"] == state["opt"]["count"] == 2 and "rng" not in state


def test_exported_workdir_synthesizes_as_the_jax_synthesizer(jax_run, tmp_path):
    cfg = load_config(os.path.join(jax_run["out"], "config.json"))
    saved = CheckpointManager(os.path.join(jax_run["out"], "checkpoints")).restore()
    model = build_model(cfg, seed=0, device="cpu")
    model.load_state_dict(saved["model"])
    ref_wav = reference_wav(cfg.audio.sample_rate)
    got = Synthesizer(cfg, model, device="cpu", deterministic_prenet=True)(
        TEXTS, reference_wavs=[ref_wav, ref_wav], seed=0)
    ref = jax_run["ref"]
    assert got["mel"].shape == ref["mel"].shape == (2, 20, 80)
    np.testing.assert_array_equal(got["frame_lengths"], ref["frame_lengths"])
    for b in range(2):
        err = np.abs(got["mel"][b] - ref["mel"][b])
        assert err.mean() < 1e-4 and err.max() < 1e-3, (err.mean(), err.max())
    paths = synthesize_main(["--workdir", jax_run["out"], "--out", str(tmp_path / "o"),
                             "--device", "cpu", "--texts", TEXTS[0]])
    assert [os.path.basename(p) for p in paths if p.endswith(".wav")] == ["synth_000.wav"]


def test_exported_workdir_resumes_as_the_jax_trainer(jax_run, tmp_path):
    work = str(tmp_path / "work")
    shutil.copytree(jax_run["out"], work)
    cfg = load_config(os.path.join(work, "config.json"))
    trainer = Trainer(cfg, port_patterns(cfg, str(tmp_path / "p")), work, device="cpu")
    assert trainer.restore_if_available() and trainer.state.step == 2
    assert trainer.state.opt.count == 2
    trainer.train(3)
    last = [json.loads(x) for x in open(os.path.join(work, "logs", "metrics.jsonl"))][-1]
    ref = jax_run["ref"]
    assert last["step"] == int(ref["next_step"]) == 3
    assert_step_matches(last, ref)
    got = export_flat(trainer.state.model)
    want = flatten_tree({"params": ref["params_after"], "batch_stats": ref["batch_stats_after"]})
    assert got.keys() == want.keys()
    for k, w in want.items():
        atol = 1e-5 * float(np.abs(w).max()) if k.startswith("batch_stats/") else 5e-5
        np.testing.assert_allclose(got[k], np.asarray(w), atol=atol, rtol=0, err_msg=k)
    assert os.path.exists(os.path.join(work, "checkpoints", "step_00000003.pt"))


@pytest.fixture(scope="module")
def vocoder_run(tmp_path_factory):
    """A JAX ``VocoderTrainer`` run of 2 steps at small widths, exported."""
    from gst_tacotron_tpu.config import save_config
    from gst_tacotron_tpu.data import generate_patterns as jgenerate
    from gst_tacotron_tpu.data import synthetic_utterances as jutterances
    from gst_tacotron_tpu.vocoder_train import VocoderTrainer as JVocoderTrainer

    tmp = tmp_path_factory.mktemp("voc")
    cfg = japply(fixture_config(), {"model.vocoder.kind": "wavernn",
                                    "model.vocoder.wavernn_gru_dim": 16,
                                    "model.vocoder.wavernn_fc_dim": 16,
                                    "model.vocoder.wavernn_hop": 128})
    patterns = str(tmp / "patterns")
    jgenerate(jutterances(4), cfg.audio, patterns, store_wav=True)
    jt = JVocoderTrainer(cfg, patterns, str(tmp / "work"), segment_frames=4, batch_size=2)
    jt.train(2)
    save_config(cfg, str(tmp / "config.json"))
    export(str(tmp / "work"), str(tmp / "export"), vocoder=True, config=str(tmp / "config.json"))
    return {"cfg": cfg, "jt": jt, "patterns": patterns, "out": str(tmp / "export")}


def test_exported_vocoder_samples_and_resumes_as_jax(vocoder_run, tmp_path):
    from gst_tacotron_tpu.models.wavernn import WaveRNN as JWaveRNN

    jt, out = vocoder_run["jt"], vocoder_run["out"]
    params = jax.device_get(jt.state.params)
    flat = load_wavernn_variables(out)
    want = flatten_tree({"params": params})
    assert flat.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)
    cfg = load_config(os.path.join(out, "config.json"))
    mel = np.random.default_rng(0).uniform(0, 1, (2, 3, 80)).astype(np.float32)
    jvoc = JWaveRNN(cfg.model.vocoder, 80)
    ref = np.asarray(jvoc.apply({"params": params}, jnp.asarray(mel), jax.random.PRNGKey(0),
                                greedy=True, method=jvoc.sample))
    voc = WaveRNNVocoder(cfg, build_wavernn(cfg, flat=flat, device="cpu"), device="cpu",
                         greedy=True)
    np.testing.assert_allclose(voc({"mel": torch.from_numpy(mel)}).numpy(), ref, atol=1e-6)

    work = str(tmp_path / "voc")
    shutil.copytree(out, work)
    vt = VocoderTrainer(cfg, vocoder_run["patterns"], work, device="cpu", segment_frames=4,
                        batch_size=2)
    assert vt.restore_if_available() and vt.state.step == 2 and vt.state.opt.count == 2
    batch = next(iter(vt.loader))
    jt.state, jm = jt.step_fn(jt.state, {k: jnp.asarray(v) for k, v in batch.items()})
    got = vt.step(batch)
    assert vt.state.step == 3
    np.testing.assert_allclose(float(got["loss"]), float(jm["loss"]), rtol=1e-5)
    after = flatten_tree({"params": jax.device_get(jt.state.params)})
    mine = export_flat(vt.model)
    for k, v in after.items():
        np.testing.assert_allclose(mine[k], np.asarray(v), atol=5e-5, rtol=0, err_msg=k)


def test_committed_fixture_still_holds_the_jax_outputs(tmp_path):
    exp = dict(np.load(os.path.join(FIXTURE, "expected.npz")))
    cfg = load_config(os.path.join(FIXTURE, "config.json"))
    saved = CheckpointManager(os.path.join(FIXTURE, "checkpoints")).restore()
    model = build_model(cfg, seed=0, device="cpu")
    model.load_state_dict(saved["model"])
    got = Synthesizer(cfg, model, device="cpu", deterministic_prenet=True)(
        [str(t) for t in exp["texts"]], reference_wavs=[exp["ref_wav"]] * 2, seed=0)
    np.testing.assert_array_equal(got["frame_lengths"], exp["frame_lengths"])
    assert np.abs(got["mel"] - exp["mel"]).mean() < 1e-4
    work = str(tmp_path / "work")
    shutil.copytree(FIXTURE, work)
    trainer = Trainer(cfg, port_patterns(cfg, str(tmp_path / "p")), work, device="cpu")
    assert trainer.restore_if_available() and trainer.state.step == 2
    trainer.train(3)
    last = [json.loads(x) for x in open(os.path.join(work, "logs", "metrics.jsonl"))][-1]
    assert_step_matches(last, exp)


def test_export_refuses_to_replace_another_config(tmp_path):
    from gst_tacotron_tpu.config import save_config

    work, out = tmp_path / "work", tmp_path / "out"
    work.mkdir()
    out.mkdir()
    save_config(fixture_config(), str(work / "config.json"))
    save_config(fixture_config(**{"train.seed": 7}), str(out / "config.json"))
    with pytest.raises(FileExistsError, match="another config"):
        export(str(work), str(out))
    shutil.copy(work / "config.json", out / "config.json")
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        export(str(work), str(out))     # the same config passes the guard
