"""The port's bench (``gst_tacotron_tpu_torch/bench.py``) on the CPU: its
workload is ``bench.py::build``'s (the same config overrides, token ids and
reference mel, drawn in the same order), it refuses to run without a card,
and its timed functions run end to end at small widths on CPU tensors (the
numbers of a CPU run are no device metric and are not read here); its
``--scaling`` curve runs on gloo processes on the CPU; its ``--train-bench``
draws ``bench.py::bench_train``'s arrays and runs its three transports at a
cut size on the CPU."""

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


@pytest.fixture(scope="module")
def scaling_rows():
    return bench.bench_scaling("cpu", counts=(1, 2), steps=1)


def test_scaling_curve_on_gloo_processes(scaling_rows):
    """``--scaling --device cpu``: one row a rank count with the four
    workloads' rates (the train step, the contention control, chunked
    synthesis, WaveRNN sampling), each time from every rank, each
    efficiency 1 at one rank."""
    rows = scaling_rows
    assert [r["ranks"] for r in rows] == [1, 2]
    for key, eff in bench.EFFICIENCIES:
        assert rows[0][eff] == 1.0, eff
        assert all(r[key] > 0 and r[eff] > 0 for r in rows), key
    assert all(r["ms_per_step"] > 0 and r["rows_per_rank"] == 2 for r in rows)
    assert [len(r["launches"]) for r in rows] == [1, 2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(["--scaling"])


def test_scaling_workloads_are_the_jax_childs():
    """The CPU widths of bench.py's scaling child: the full
    ``_tiny_overrides()``, synthesis of 2 rows a rank for 8 steps in chunks
    of 4, a WaveRNN of GRU 16, fc 16, hop 4 on 2 rows of 6 frames."""
    import __graft_entry__ as graft

    assert graft._tiny_overrides() == bench.TINY
    scfg, rows, max_steps, chunk = bench.synth_workload(True)
    assert (rows, max_steps, chunk) == (2, 8, 4) and scfg.audio.griffin_lim_iters == 4
    wcfg, rows, frames = bench.wavernn_workload(True)
    v = wcfg.model.vocoder
    assert (v.wavernn_gru_dim, v.wavernn_fc_dim, v.wavernn_hop, rows, frames) == (16, 16, 4, 2, 6)
    assert (bench.CONTROL_ROWS, bench.CONTROL_WIDTH, bench.CONTROL_UPDATES) == (64, 512, 30)


def test_scaling_synthesis_ranks_agree_on_chunks(scaling_rows):
    """The stop consensus: every rank of a point ran as many chunks."""
    for r in scaling_rows:
        assert len(r["chunks_run"]) == r["ranks"] and len(set(r["chunks_run"])) == 1
        assert 1 <= r["chunks_run"][0] <= r["synth_max_steps"] // r["chunk_steps"]


def test_scaling_wavernn_ranks_sample_their_rows(scaling_rows):
    """Each rank's WaveRNN classes are the single-process sampler's rows it
    holds, exactly (as the dp=2 check of tests/test_torch_parallel_vocoder.py
    holds K5's plain twin)."""
    from gst_tacotron_tpu_torch.weights import build_wavernn

    wcfg, rows, frames = bench.wavernn_workload(True)
    for r in scaling_rows:
        n = r["ranks"]
        mel = torch.from_numpy(bench.wavernn_mel(wcfg, rows * n, frames))
        with torch.no_grad():
            classes = build_wavernn(wcfg, seed=1, device="cpu").sample_classes(
                mel, seed=bench.WAVERNN_SEED)
        assert classes.shape == (rows * n, frames * 4)
        assert r["wavernn_digests"] == [bench.classes_digest(classes[i * rows:(i + 1) * rows])
                                        for i in range(n)]


@pytest.mark.parametrize("transport", ["features", "wav"])
def test_train_bench_arrays_match_the_jax_bench(transport):
    """``bench.py::bench_train``'s feature batch and wire, drawn in its
    order (its full-size init stubbed out: only the arrays are compared)."""
    import gst_tacotron_tpu.train as jtrain

    seen = {}

    class Stop(Exception):
        pass

    def capture(cfg, rng, feat):
        seen["cfg"], seen["feat"] = cfg, feat
        raise Stop

    mp = pytest.MonkeyPatch()
    mp.setattr(jtrain, "init_state", capture)
    try:
        with pytest.raises(Stop):
            jbench.bench_train(transport)
    finally:
        mp.undo()
    cfg = apply_overrides(load_config_gst_lj(), {"data.batch_size": 8})
    feat, wire, _ = bench.train_bench_wire(cfg, transport, 8, 64, 400)
    for key, ref in seen["feat"].items():
        np.testing.assert_array_equal(feat[key], ref, err_msg=key)
        assert feat[key].dtype == ref.dtype, key
    if transport == "wav":
        assert wire["wav"].dtype == np.float16 and wire["wav"].shape == (8, 399 * 256 + 2048)
        np.testing.assert_array_equal(wire["ints"][:, 64:67], [[64, 400, 400]] * 8)
    assert seen["cfg"].data.batch_size == 8


def load_config_gst_lj():
    from gst_tacotron_tpu_torch.config import get_preset

    return get_preset("gst_lj")


def test_train_bench_runs_every_transport_on_cpu_tensors():
    line = bench.train_bench_line(1, device="cpu", overrides=bench.TINY, batch=2, t_text=8,
                                  t_mel=16)
    assert line["metric"] == "train_ms_per_step" and line["unit"] == "ms/step (wav transport)"
    assert [r["transport"] for r in line["rows"]] == list(bench.TRANSPORTS)
    assert line["value"] == line["rows"][1]["ms_per_step"] > 0
    assert line["vs_baseline"] == line["rows"][0]["ms_per_step"] / line["value"]
    assert all(np.isfinite(r["loss"]) and r["batch"] == 2 for r in line["rows"])
    # the corpus rows are the wire's rows: the same first-step data
    assert line["rows"][2]["wire_mb_per_batch"] == 2 * 4 / 1e6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(["--train-bench"])
