"""``parallel.DistributedSynthesizer`` of the port on the CPU, two gloo
ranks (``tests/torch_dist_workers.py``), small_cfg's gst_lj widths, three
texts (padded to four rows at dp=2 by repeating the last, the padding
trimmed) with reference wavs through K3's plain version, against the
single-process port ``Synthesizer`` on the same four rows and seed (the
encoder prenet's two dropout draws follow one generator, so a batch of
three rows draws other masks than the padded batch of four):

* dp=2, the fixed-length path with prenet dropout on: every output within
  1e-5 (each rank's rows draw the dropout of their rows of the global
  batch: the encoder prenet's mask, K4's Philox ``row0``), and both ranks
  return the whole batch;
* the chunked path at stop thresholds 1.0 and 0.0: ``chunks_run`` equal on
  both ranks and to the single-process chunked call's (every chunk, one);
* (1, 2), tensor parallel: a model whose ruled kernels are stored sharded is
  gathered once; the fixed path gives the single-process outputs on the
  three rows, and the chunked path is refused.
"""

import numpy as np
import pytest
import torch

from gst_tacotron_tpu_torch.config import apply_overrides
from gst_tacotron_tpu_torch.synthesize import Synthesizer
from gst_tacotron_tpu_torch.weights import build_model

from tests.test_torch_parallel_train import port_config
from tests.torch_dist_workers import run_ranks

torch.set_num_threads(2)

TEXTS = ["the first sentence.", "a second, longer sentence of the batch.", "third."]
STEPS, CHUNK = 6, 4
TOL = 1e-5
KEYS = ("mel", "linear", "stop_logits", "alignments", "frame_lengths", "wav")


def reference_wavs(rng, hop):
    return [rng.uniform(-0.5, 0.5, n * hop).astype(np.float32) for n in (20, 33, 27)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = port_config(tmp_path_factory)
    wavs = reference_wavs(np.random.default_rng(0), cfg.audio.hop_length)
    call = dict(texts=TEXTS, reference_wavs=wavs, max_steps=STEPS, seed=3)
    cfgs = {t: apply_overrides(cfg, {"model.decoder.stop_threshold": t}) for t in (1.0, 0.0)}
    calls = [(cfg, 1, call)]
    calls += [(cfgs[t], 1, dict(call, chunked=True, chunk_steps=CHUNK)) for t in cfgs]
    calls += [(cfg, 2, call), (cfg, 2, dict(call, chunked=True, chunk_steps=CHUNK))]
    ranks = run_ranks("synthesize", 2, calls)

    def single(c, chunked=False, pad=1):
        synth = Synthesizer(c, build_model(c, seed=0, device="cpu"), device="cpu",
                            use_chunked_decoder=chunked, chunk_steps=CHUNK)
        out = synth(TEXTS + TEXTS[-1:] * pad, reference_wavs=wavs + wavs[-1:] * pad,
                    max_steps=STEPS, seed=3)
        return {k: v[: len(TEXTS)] if isinstance(v, np.ndarray) else v for k, v in out.items()}

    ref = {"fixed": single(cfg), "unpadded": single(cfg, pad=0),
           **{f"chunked_{t}": single(cfgs[t], True) for t in cfgs}}
    names = ["fixed", "chunked_1.0", "chunked_0.0", "tp_fixed", "tp_chunked"]
    return ref, {n: [r[i] for r in ranks] for i, n in enumerate(names)}


def assert_outputs(got, ref):
    for k in KEYS:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=0, err_msg=k)


def test_data_parallel_fixed_path_matches_the_synthesizer(runs):
    ref, got = runs
    (s0, r0), (s1, r1) = got["fixed"]
    assert s0 == s1 == []
    assert r0["mel"].shape[0] == len(TEXTS)
    assert_outputs(r0, ref["fixed"])
    for k in KEYS:   # every rank returns the whole batch
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)


@pytest.mark.parametrize("threshold,chunks", [("1.0", -(-STEPS // CHUNK)), ("0.0", 1)])
def test_chunked_path_stops_together(runs, threshold, chunks):
    ref, got = runs
    (_, r0), (_, r1) = got[f"chunked_{threshold}"]
    assert r0["chunks_run"] == r1["chunks_run"] == ref[f"chunked_{threshold}"]["chunks_run"]
    assert r0["chunks_run"] == chunks
    np.testing.assert_array_equal(r0["mel"], r1["mel"])
    assert r0["mel"].shape == ref[f"chunked_{threshold}"]["mel"].shape


def test_tensor_parallel_gathers_the_kernels_once(runs):
    ref, got = runs
    for sharded, out in got["tp_fixed"]:     # a data axis of one: no padding
        assert "decoder.cell.frame_proj.kernel" in sharded
        assert_outputs(out, ref["unpadded"])
    for _, out in got["tp_chunked"]:
        assert isinstance(out, str) and "model_parallelism=1" in out
