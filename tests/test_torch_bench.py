"""The port's bench (``gst_tacotron_tpu_torch/bench.py``) on the CPU: its
workload is ``bench.py::build``'s (the same config overrides, token ids and
reference mel, drawn in the same order), it refuses to run without a card,
and its timed functions run end to end at small widths on CPU tensors (the
numbers of a CPU run are no device metric and are not read here); its
``--scaling`` curve runs on gloo processes on the CPU."""

import numpy as np
import pytest
import torch

import bench as jbench
from gst_tacotron_tpu_torch import bench
from gst_tacotron_tpu_torch.config import apply_overrides, load_config
from gst_tacotron_tpu_torch.weights import build_model

from tests.test_train_smoke import small_cfg

torch.set_num_threads(2)


@pytest.fixture
def jax_build_inputs(monkeypatch):
    """``bench.py::build`` with its (full-size) model init stubbed out: its
    config and its sample arrays."""
    import gst_tacotron_tpu.train as jtrain

    monkeypatch.setattr(jtrain, "init_state", lambda cfg, rng, sample: (None, None))
    return jbench.build


@pytest.mark.parametrize("batch", [32, 3])
def test_workload_matches_the_jax_bench(jax_build_inputs, batch):
    jcfg, _, _, jsample = jax_build_inputs(batch=batch)
    cfg, sample = bench.workload(batch)
    for key in ("tokens", "token_lengths", "mel", "mel_lengths"):
        np.testing.assert_array_equal(sample[key], jsample[key], err_msg=key)
        assert sample[key].dtype == jsample[key].dtype, key
    for name in ("max_decode_steps", "stop_threshold"):
        assert getattr(cfg.model.decoder, name) == getattr(jcfg.model.decoder, name)
    for name in ("griffin_lim_iters", "griffin_lim_momentum", "griffin_lim_bf16"):
        assert getattr(cfg.audio, name) == getattr(jcfg.audio, name)
    assert cfg.name == jcfg.name == "gst_lj"


def test_bench_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--quick"])


def test_bench_functions_run_on_cpu_tensors(tmp_path):
    from gst_tacotron_tpu.config import save_config

    path = str(tmp_path / "config.json")
    save_config(small_cfg("gst_lj", **{"model.decoder.max_decode_steps": 3,
                                       "audio.griffin_lim_iters": 2,
                                       "model.vocoder.wavernn_gru_dim": 16,
                                       "model.vocoder.wavernn_fc_dim": 16}), path)
    cfg = apply_overrides(load_config(path), {"model.decoder.stop_threshold": 1.0})
    _, sample = bench.workload(2)
    sample["mel"] = sample["mel"][..., : cfg.model.num_mels]
    model = build_model(cfg, seed=0, device="cpu")
    fused = bench.bench_fused(cfg, model, sample, iterations=1, repeats=2)
    r = cfg.model.decoder.reduction_factor
    assert fused["frames"] == 2 * 3 * r and len(fused["ms_per_batch"]) == 2
    per_step, gl = bench.bench_reference_style(cfg, model, sample, max_steps=2)
    assert per_step > 0 and gl > 0
    c5 = bench.bench_config5(cfg, model, sample, iterations=1)
    assert c5["wav_samples_per_batch"] == 2 * 3 * r * cfg.audio.hop_length


def test_scaling_curve_on_gloo_processes():
    """``--scaling --device cpu``: one row a rank count, ms a step from
    every rank, efficiency 1 at one rank; the fake-mesh widths are the JAX
    bench's (``__graft_entry__._tiny_overrides``)."""
    import __graft_entry__ as graft

    assert {k: v for k, v in graft._tiny_overrides().items()
            if k != "audio.griffin_lim_iters"} == bench.TINY
    rows = bench.bench_scaling("cpu", counts=(1, 2), steps=1)
    assert [r["ranks"] for r in rows] == [1, 2]
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    assert all(r["ms_per_step"] > 0 and r["rows_per_rank"] == 2 for r in rows)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(["--scaling"])
