"""The chunked early-exit decode (``decode.py``) and K4's carried state on
the CPU, against the JAX package's ``gst_tacotron_tpu/decode.py``:

* the contract of tests/test_chunked_decode.py: the shapes of the
  ``num_chunks * chunk_steps`` budget, stop threshold 0 runs one chunk,
  threshold 1.0 runs every chunk at full length;
* the port's ``chunked_decode`` (chunks on the plain version of K4) against
  JAX's (chunks on its scan) from the same memory at
  ``deterministic_prenet=True``: 1e-5;
* a chunked decode gives the bits of one fixed-length call over the same
  steps, at any chunk size, both attention kinds, dropout on and off;
* the chunked ``Synthesizer`` against the JAX chunked ``Synthesizer``
  (prenet dropout 0 on both sides): mel MAE < 1e-4;
* ``data_parallel_stop_consensus`` over a 2-process gloo group.
"""

import multiprocessing
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.config import apply_overrides as japply
from gst_tacotron_tpu.config import save_config
from gst_tacotron_tpu.decode import chunked_decode as jchunked_decode
from gst_tacotron_tpu.models import GSTTacotron as JGSTTacotron
from gst_tacotron_tpu.synthesize import Synthesizer as JSynthesizer
from gst_tacotron_tpu.text import NUM_SYMBOLS
from gst_tacotron_tpu.train import build_model as jbuild
from gst_tacotron_tpu_torch.config import apply_overrides, load_config
from gst_tacotron_tpu_torch.decode import chunked_decode
from gst_tacotron_tpu_torch.ops.decode import decode_carry, decode_scan_plain
from gst_tacotron_tpu_torch.synthesize import Synthesizer
from gst_tacotron_tpu_torch.weights import build_model

from tests.test_model import make_batch, tiny_config
from tests.test_torch_synth_configs import flatten_tree, reference_wavs
from tests.test_train_smoke import small_cfg
from tests.torch_dist_workers import consensus_worker

torch.set_num_threads(2)


def port_config(jcfg, path):
    save_config(jcfg, path)
    return load_config(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """tests/test_chunked_decode.py's model and memory (taco1_lj at the
    tiny widths, 16 steps), and the port's model from the same variables."""
    jcfg = japply(tiny_config("taco1_lj"), {"model.decoder.max_decode_steps": 16})
    tokens, token_lengths, mel = make_batch(jcfg)
    jmodel = JGSTTacotron(jcfg.model, NUM_SYMBOLS)
    variables = jax.jit(lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                                             "dropout": jax.random.PRNGKey(1)},
                                            tokens, token_lengths, mel, train=False))()
    memory, _ = jax.jit(lambda v: jmodel.apply(
        v, tokens, token_lengths, None, None, None, None, False, method=jmodel._build_memory,
        rngs={"dropout": jax.random.PRNGKey(2)}))(variables)
    cfg = port_config(jcfg, str(tmp_path_factory.mktemp("cfg") / "config.json"))
    return dict(jcfg=jcfg, cfg=cfg, variables=variables, flat=flatten_tree(variables),
                memory=np.array(memory), lengths=np.array(token_lengths))


def port_model(setup, **overrides):
    cfg = apply_overrides(setup["cfg"], overrides)
    return build_model(cfg, flat=setup["flat"], device="cpu")


def port_chunked(setup, model, **kw):
    with torch.no_grad():
        return chunked_decode(model, torch.from_numpy(setup["memory"]),
                              torch.from_numpy(setup["lengths"]), **kw)


def test_shapes_and_at_least_one_chunk(setup):
    out = port_chunked(setup, port_model(setup), chunk_steps=4, max_steps=12)
    r = setup["cfg"].model.decoder.reduction_factor
    assert out["mel"].shape == (2, 12 * r, setup["cfg"].model.num_mels)
    assert out["stop_logits"].shape == (2, 12 * r)
    assert out["alignments"].shape == (2, 12, setup["memory"].shape[1])
    assert out["chunks_run"] >= 1


def test_early_exit_at_threshold_zero_and_every_chunk_at_one(setup):
    out0 = port_chunked(setup, port_model(setup, **{"model.decoder.stop_threshold": 0.0}),
                        chunk_steps=4, max_steps=16)
    assert out0["chunks_run"] == 1
    r = setup["cfg"].model.decoder.reduction_factor
    assert not out0["stop_logits"][:, 4 * r:].any()       # the tail never written
    out1 = port_chunked(setup, port_model(setup, **{"model.decoder.stop_threshold": 1.0}),
                        chunk_steps=4, max_steps=16)
    assert out1["chunks_run"] == 4
    assert torch.all(out1["frame_lengths"] == 16 * r)


def test_budget_rounds_up_to_whole_chunks(setup):
    """At max_steps 10 and chunks of 4 the budget is 12 steps, as in JAX."""
    out = port_chunked(setup, port_model(setup, **{"model.decoder.stop_threshold": 1.0}),
                       chunk_steps=4, max_steps=10)
    assert out["chunks_run"] == 3 and out["alignments"].shape[1] == 12


@pytest.mark.parametrize("threshold", [0.5, 1.0])
def test_matches_jax_chunked_decode(setup, threshold):
    jcfg = japply(setup["jcfg"], {"model.decoder.stop_threshold": threshold})
    jmodel = JGSTTacotron(jcfg.model, NUM_SYMBOLS)
    ref = jchunked_decode(jmodel, setup["variables"], jnp.asarray(setup["memory"]),
                          jnp.asarray(setup["lengths"]), jax.random.PRNGKey(0), chunk_steps=4,
                          max_steps=16, deterministic_prenet=True)
    got = port_chunked(setup, port_model(setup, **{"model.decoder.stop_threshold": threshold}),
                       chunk_steps=4, max_steps=16, deterministic_prenet=True)
    assert got["chunks_run"] == int(ref["chunks_run"])
    np.testing.assert_array_equal(got["frame_lengths"].numpy(), np.asarray(ref["frame_lengths"]))
    for key in ("mel", "stop_logits", "alignments"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=1e-5, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("kind", ["bahdanau", "location_sensitive"])
@pytest.mark.parametrize("deterministic", [False, True])
def test_chunked_plain_decode_gives_the_fixed_length_bits(setup, kind, deterministic):
    over = {"model.decoder.stop_threshold": 1.0, "model.attention.kind": kind,
            "model.attention.location_filters": 4, "model.attention.location_kernel_size": 5}
    cfg = apply_overrides(setup["cfg"], over)
    model = build_model(cfg, seed=4, device="cpu")
    memory = torch.from_numpy(setup["memory"])
    lengths = torch.from_numpy(setup["lengths"])
    with torch.no_grad():
        fixed = model.decoder.decode(memory, lengths, max_steps=14,
                                     deterministic_prenet=deterministic, seed=7)
        for chunk in (1, 5, 14):
            out = chunked_decode(model, memory, lengths, chunk_steps=chunk, max_steps=14,
                                 deterministic_prenet=deterministic, seed=7)
            n = fixed[0].shape[1]
            assert torch.equal(out["mel"][:, :n], fixed[0]), chunk
            assert torch.equal(out["stop_logits"][:, :n], fixed[1]), chunk
            assert torch.equal(out["alignments"][:, :14], fixed[2]), chunk
        # the carry directly, in uneven calls
        dec = model.decoder
        packed, keys = dec.cell.pack(), dec.cell.precompute_keys(memory)
        kw = dict(dec_cfg=dec.cfg, attn_cfg=dec.attn_cfg, num_mels=dec.num_mels, seed=7,
                  use_dropout=not deterministic)
        carry = decode_carry(memory, dec_cfg=dec.cfg, num_mels=dec.num_mels, total_steps=14)
        for steps in (3, 1, 6, 4):
            decode_scan_plain(packed, memory, keys, lengths, steps=steps, carry=carry, **kw)
        one = decode_scan_plain(packed, memory, keys, lengths, steps=14, **kw)
        assert carry.step == 14
        for x, y in zip((carry.mel, carry.stop_logits, carry.aligns), one):
            assert torch.equal(x, y)
        with pytest.raises(ValueError, match="past the carry"):
            decode_scan_plain(packed, memory, keys, lengths, steps=1, carry=carry, **kw)


def test_chunked_synthesizer_matches_jax(tmp_path):
    jcfg = small_cfg("gst_lj", **{"model.encoder.prenet_dropout": 0.0,
                                  "model.decoder.prenet_dropout": 0.0,
                                  "model.decoder.max_decode_steps": 10,
                                  "audio.griffin_lim_iters": 2,
                                  "audio.griffin_lim_bf16": False})
    cfg = port_config(jcfg, str(tmp_path / "config.json"))
    jmodel = jbuild(jcfg)
    tokens = jnp.zeros((1, 8), jnp.int32)
    variables = jax.jit(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(1)}, tokens,
        jnp.array([8]), jnp.zeros((1, 4, 80)), train=False, ref_mel=jnp.zeros((1, 64, 80)),
        ref_mel_lengths=jnp.array([64])))()
    texts = ["chunked decoding.", "a second sentence here."]
    wavs = reference_wavs(jcfg.audio.sample_rate)
    ref = JSynthesizer(jcfg, jmodel, variables, use_chunked_decoder=True, chunk_steps=4,
                       deterministic_prenet=True)(texts, reference_wavs=wavs, seed=0)
    got = Synthesizer(cfg, build_model(cfg, flat=flatten_tree(variables), device="cpu"),
                      device="cpu", deterministic_prenet=True, use_chunked_decoder=True,
                      chunk_steps=4)(texts, reference_wavs=wavs, seed=0)
    assert got["chunks_run"] == int(ref["chunks_run"])
    np.testing.assert_array_equal(got["frame_lengths"], ref["frame_lengths"])
    assert got["mel"].shape == ref["mel"].shape
    assert np.mean(np.abs(got["mel"] - ref["mel"])) < 1e-4
    assert got["wav"].shape == np.asarray(ref["wav"]).shape


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_stop_consensus_over_two_gloo_processes():
    """One rank with a row still running keeps both going; both finished
    stops both."""
    flags = {0: [[True, True], [True, True]], 1: [[True, False], [True, True]]}
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=consensus_worker, args=(r, port, flags, out)) for r in (0, 1)]
    for p in procs:
        p.start()
    try:
        results = dict(out.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert all(not p.is_alive() for p in procs)
    for rank in (0, 1):
        assert results[rank] == [[False, False], [True, True]]
