"""The port's alignment gate (``gst_tacotron_tpu_torch/alignment_gate.py``)
against the JAX gate, ``tests/test_alignment_gate.py`` (loaded by path,
unedited), on the CPU: the same config, field by field; the same corpus,
metadata and every array bit for bit; from the JAX trainer's initial
weights, the same untrained teacher-forced diagonality on the loader's
first batch (1e-5). Its 800 steps run on the card
(``tests/test_torch_cuda.py::test_alignment_gate_on_the_card``); here a 5-step run
shows the function runs end to end."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from gst_tacotron_tpu import config as jconfig
from gst_tacotron_tpu.train import Trainer as JaxTrainer
from gst_tacotron_tpu_torch import alignment_gate as gate
from gst_tacotron_tpu_torch import config as tconfig
from gst_tacotron_tpu_torch.tf_import import flatten
from gst_tacotron_tpu_torch.train import Trainer
from gst_tacotron_tpu_torch.weights import load_flat

torch.set_num_threads(2)

DIAG_TOL = 1e-5


@pytest.fixture(scope="module")
def jgate():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_alignment_gate.py")
    spec = importlib.util.spec_from_file_location("jax_alignment_gate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpora(jgate, tmp_path_factory):
    """(the port's corpus, JAX's corpus), each written by its own writer."""
    root = tmp_path_factory.mktemp("corpora")
    port, jax = str(root / "port"), str(root / "jax")
    gate.write_token_pattern_corpus(gate.gate_config(), port)
    jgate.write_token_pattern_corpus(jgate.gate_config(), jax)
    return port, jax


def test_gate_constants_and_config_match_jax(jgate):
    assert (gate.GATE_STEPS, gate.GATE_THRESHOLD) == (jgate.GATE_STEPS, jgate.GATE_THRESHOLD)
    assert tconfig.to_jax_dict(gate.gate_config()) == jconfig.to_dict(jgate.gate_config())


def test_corpus_matches_jax(corpora):
    port, jax = corpora
    meta = lambda d: json.load(open(os.path.join(d, "metadata.json")))
    assert meta(port) == meta(jax)
    names = sorted(f for f in os.listdir(jax) if f.endswith(".npz"))
    assert names == sorted(f for f in os.listdir(port) if f.endswith(".npz")) and len(names) == 32
    for name in names:
        with np.load(os.path.join(port, name)) as a, np.load(os.path.join(jax, name)) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")


def first_batch(loader):
    it = iter(loader)
    try:
        return next(it)
    finally:
        it.close()


def test_untrained_diagonality_matches_jax(jgate, corpora, tmp_path):
    """The JAX trainer's initial parameters and batch statistics carried
    into the port's trainer: the same probe batch, the same teacher-forced
    diagonality."""
    _, patterns = corpora
    jtrainer = JaxTrainer(jgate.gate_config(), patterns, str(tmp_path / "jax"))
    jprobe = jtrainer._device_batch(first_batch(jtrainer.loader))
    expected = jgate._teacher_forced_diag(jtrainer, jprobe)

    trainer = Trainer(gate.gate_config(), patterns, str(tmp_path / "port"), device="cpu")
    load_flat(trainer.state.model, {**flatten(jtrainer.state.params, "params"),
                                    **flatten(jtrainer.state.batch_stats, "batch_stats")})
    host = first_batch(trainer.loader)
    for k, v in host.items():
        np.testing.assert_array_equal(v, np.asarray(jprobe[k]), err_msg=k)
    got = gate.teacher_forced_diagonality(trainer, trainer._device_batch(host))
    assert 0.0 <= expected <= 1.0
    assert abs(got - expected) <= DIAG_TOL, (got, expected)


def test_run_gate_runs_on_cpu(tmp_path):
    res = gate.run_gate(str(tmp_path), device="cpu", steps=5)
    assert res.steps == 5 and np.isfinite(res.loss) and res.seconds > 0
    assert 0.0 <= res.untrained <= 1.0 and 0.0 <= res.trained <= 1.0
    assert res.trainer.state.step == 5
    # five steps are far from the gate: it reports what it misses
    assert len(gate.gate_failures(res)) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gate.run_gate(str(tmp_path / "card"), steps=1)
