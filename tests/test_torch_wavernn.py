"""K5 and the WaveRNN vocoder on the CPU: the port against the JAX package.

* mu-law encode (exact) and decode (1e-6) against ``jax_dsp``;
* ``upsample_cond`` and the teacher-forced forward against the flax
  ``WaveRNN`` at atol 1e-5, with the same weights through ``load_flat``;
* greedy sampling class for class: the port's ``wavernn_sample_plain``
  against ``wavernn_sample_pallas(interpret=True, greedy=True)`` and the
  flax ``WaveRNN.sample(greedy=True)``, at the sizes of
  tests/test_wavernn_pallas.py;
* the Philox Gumbel stream the kernel and the plain version share: seeded,
  strictly inside (0, 1), numpy and torch twins equal; and Gumbel-max at
  fixed logits samples their softmax (it cannot match jax.random's stream);
* the vocoder wrappers;
* the kernel's hoisted input product (``input_tables``) against the
  un-hoisted step's gates, and its score keys' order.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.config import VocoderConfig as JVocoderConfig
from gst_tacotron_tpu.dsp import jax_dsp
from gst_tacotron_tpu.models.wavernn import WaveRNN as JWaveRNN
from gst_tacotron_tpu.ops.wavernn_pallas import pack_wavernn_weights, wavernn_sample_pallas
from gst_tacotron_tpu_torch.config import VocoderConfig, apply_overrides, get_preset
from gst_tacotron_tpu_torch.dsp.mulaw import mulaw_decode, mulaw_encode
from gst_tacotron_tpu_torch.models.wavernn import WaveRNN
from gst_tacotron_tpu_torch.ops import wavernn as twavernn
from gst_tacotron_tpu_torch.vocoder import (GriffinLimVocoder, WaveRNNVocoder,
                                            check_vocoder_hop, make_vocoder)
from gst_tacotron_tpu_torch.weights import build_wavernn, load_flat

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "tools"))
from make_golden_fixtures import flatten_tree  # noqa: E402

torch.set_num_threads(2)

CFG_KW = dict(kind="wavernn", wavernn_gru_dim=16, wavernn_fc_dim=16, wavernn_bits=8,
              wavernn_hop=4)
NUM_MELS = 8


def build(t_frames=5, batch=2):
    """The flax WaveRNN of tests/test_wavernn_pallas.py, its variables with
    nonzero biases, and the port's WaveRNN with the same weights."""
    rng = np.random.default_rng(0)
    mel = rng.random((batch, t_frames, NUM_MELS)).astype(np.float32)
    jmodel = JWaveRNN(JVocoderConfig(**CFG_KW), NUM_MELS)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(mel),
                            jnp.zeros((batch, t_frames * CFG_KW["wavernn_hop"])))
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (rng.normal(0, 0.1, x.shape).astype(np.float32)
                                   if x.ndim == 1 else 0.0), variables["params"])
    model = WaveRNN(VocoderConfig(**CFG_KW), NUM_MELS)
    load_flat(model, flatten_tree({"params": params}))
    return jmodel, {"params": params}, model, mel


def test_mulaw_matches_jax_dsp():
    rng = np.random.default_rng(3)
    wav = np.concatenate([rng.uniform(-1.2, 1.2, 4000), [-1.0, 0.0, 1.0, 1e-9, -1e-9]])
    wav = wav.astype(np.float32)
    for bits in (8, 5):
        got = mulaw_encode(torch.from_numpy(wav), bits)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_dsp.mulaw_encode(wav, bits)))
        classes = np.arange(2 ** bits, dtype=np.int32)
        dec = mulaw_decode(torch.from_numpy(classes), bits).numpy()
        np.testing.assert_allclose(dec, np.asarray(jax_dsp.mulaw_decode(classes, bits)),
                                   atol=1e-6)
        assert np.abs(dec).max() <= 1.0
        # every class survives the round trip
        np.testing.assert_array_equal(mulaw_encode(torch.from_numpy(dec), bits).numpy(), classes)


def test_upsample_cond_and_teacher_forced_forward_match_flax():
    jmodel, variables, model, mel = build()
    rng = np.random.default_rng(1)
    wav = rng.uniform(-1, 1, (2, 5 * CFG_KW["wavernn_hop"])).astype(np.float32)
    with torch.no_grad():
        cond = model.upsample_cond(torch.from_numpy(mel))
        logits = model(torch.from_numpy(mel), torch.from_numpy(wav))
        h = torch.from_numpy(rng.normal(0, 0.5, (2, 16)).astype(np.float32))
        prev = torch.tensor([3, 200])
        h_new, step = model._step_logits(h, prev, cond[:, 0])
    np.testing.assert_allclose(
        cond.numpy(), np.asarray(jmodel.apply(variables, jnp.asarray(mel),
                                              method=jmodel.upsample_cond)), atol=1e-5)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jmodel.apply(variables, jnp.asarray(mel), jnp.asarray(wav))),
        atol=1e-5)
    jh, jstep = jmodel.apply(variables, jnp.asarray(h.numpy()), jnp.asarray(prev.numpy()),
                             jnp.asarray(cond[:, 0].numpy()), method=jmodel._step_logits)
    np.testing.assert_allclose(h_new.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), atol=1e-5)


@pytest.mark.parametrize("t_frames,batch", [(5, 2), (3, 3)])
def test_greedy_plain_matches_pallas_and_flax(t_frames, batch):
    jmodel, variables, model, mel = build(t_frames, batch)
    jcfg = JVocoderConfig(**CFG_KW)
    jcond = jmodel.apply(variables, jnp.asarray(mel), method=jmodel.upsample_cond)
    jpacked = pack_wavernn_weights(variables["params"], jcfg)
    ref_classes = np.asarray(wavernn_sample_pallas(
        {k: jnp.asarray(v) for k, v in jpacked.items()}, jcond, cfg=jcfg, greedy=True,
        interpret=True))
    ref_wav = np.asarray(jmodel.apply(variables, jnp.asarray(mel), jax.random.PRNGKey(0),
                                      greedy=True, method=jmodel.sample))
    packed = model.pack()
    for k, v in packed.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jpacked[k]), err_msg=k)
    with torch.no_grad():
        cond = model.cond_frames(torch.from_numpy(mel))
        classes = twavernn.wavernn_sample(packed, cond, hop=4, greedy=True)
        wav = model.sample(torch.from_numpy(mel), greedy=True)
    assert classes.dtype == torch.int32 and classes.shape == (batch, t_frames * 4)
    np.testing.assert_array_equal(classes.numpy(), ref_classes)
    np.testing.assert_allclose(wav.numpy(), ref_wav, atol=1e-6)
    # the teacher-forced pass on the sampled classes puts each at its step's max
    gaps = twavernn.score_gaps(packed, cond, classes, hop=4, greedy=True)
    assert float(gaps.abs().max()) == 0.0


def test_gumbel_stream_is_seeded_and_open():
    steps = np.arange(40)
    u = twavernn.gumbel_uniforms(7, steps, 3, 256)
    assert u.dtype == np.float32 and u.shape == (40, 3, 256)
    assert u.min() > 0.0 and u.max() < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    np.testing.assert_array_equal(u, twavernn.gumbel_uniforms(7, steps, 3, 256))
    assert not np.array_equal(u, twavernn.gumbel_uniforms(8, steps, 3, 256))
    # the torch twin (the plain version's, on any device) draws the same bits
    ut = twavernn.gumbel_uniforms(7, torch.arange(40), 3, 256)
    assert ut.dtype == torch.float32
    np.testing.assert_array_equal(ut.numpy(), u)
    # a later window of the stream is the same numbers, and differs from the
    # prenet dropout streams (ids 0 and 1) of the decode kernel
    np.testing.assert_array_equal(twavernn.gumbel_uniforms(7, steps[10:], 3, 256), u[10:])
    from gst_tacotron_tpu_torch.ops.decode import dropout_uniforms

    assert not np.array_equal(dropout_uniforms(7, 40, 0, 3, 256), u)


def test_gumbel_max_samples_the_softmax():
    """A WaveRNN whose logits ignore their input samples from their softmax:
    class frequencies over 8000 draws match softmax(logits / temperature)."""
    cfg = VocoderConfig(kind="wavernn", wavernn_gru_dim=4, wavernn_fc_dim=4,
                        wavernn_bits=3, wavernn_hop=4)
    model = WaveRNN(cfg, NUM_MELS)
    from gst_tacotron_tpu_torch.weights import init_weights

    init_weights(model, seed=0)
    logits = torch.tensor([1.5, 0.2, -0.7, 0.9, 0.0, -2.0, 0.9, 0.4])
    temperature = 0.8
    with torch.no_grad():
        model.fc2.kernel.zero_()
        model.fc2.bias.copy_(logits)
        mel = torch.zeros(8, 250, NUM_MELS)
        classes = model.sample_classes(mel, seed=11, temperature=temperature)
    freq = torch.bincount(classes.flatten().long(), minlength=8).float() / classes.numel()
    want = torch.softmax(logits / temperature, 0)
    # 8000 draws: one standard deviation of a frequency is at most 0.0056
    np.testing.assert_allclose(freq.numpy(), want.numpy(), atol=0.025)
    with torch.no_grad():
        again = model.sample_classes(mel, seed=11, temperature=temperature)
        other = model.sample_classes(mel, seed=12, temperature=temperature)
    assert torch.equal(classes, again) and not torch.equal(classes, other)


def test_vocoders():
    cfg = apply_overrides(get_preset("gst_wavernn"), {
        "audio.hop_length": 4, "model.vocoder.wavernn_hop": 4,
        "model.vocoder.wavernn_gru_dim": 8, "model.vocoder.wavernn_fc_dim": 8})
    check_vocoder_hop(cfg)
    with pytest.raises(ValueError, match="wavernn_hop"):
        check_vocoder_hop(apply_overrides(cfg, {"audio.hop_length": 8}))
    with pytest.raises(ValueError, match="variables"):
        make_vocoder(cfg, device="cpu")
    gl = make_vocoder(apply_overrides(cfg, {"model.vocoder.kind": "griffin_lim"}), device="cpu")
    assert isinstance(gl, GriffinLimVocoder)
    model = build_wavernn(cfg, seed=3, device="cpu")
    flat = {f"params/{k.replace('.', '/')}": v.numpy() for k, v in model.state_dict().items()}
    voc = make_vocoder(cfg, flat, device="cpu")
    assert isinstance(voc, WaveRNNVocoder)
    mel = {"mel": torch.rand(2, 3, 80)}
    wav = voc(mel, seed=5)
    assert wav.shape == (2, 12) and float(wav.abs().max()) <= 1.0
    assert torch.equal(wav, WaveRNNVocoder(cfg, model, device="cpu")(mel, seed=5))
    assert not torch.equal(wav, voc(mel, seed=6))


@pytest.mark.parametrize("batch,t_frames", [(2, 5), (3, 2)])
def test_hoisted_input_tables_match_the_step(batch, t_frames):
    """K5 computes (embed @ wi + bi)[prev] + (cond @ wi)[frame] where the
    plain version (the JAX kernel's step) computes (embed[prev] +
    cond[frame]) @ wi + bi: the same gates to float32 rounding, and the same
    GRU update to 1e-6."""
    from gst_tacotron_tpu_torch.ops.gru import gru_update

    _, _, model, mel = build(t_frames, batch)
    packed = model.pack()
    with torch.no_grad():
        cond = model.cond_frames(torch.from_numpy(mel))
    table, cond_table = twavernn.input_tables(packed, cond)
    k, h3 = packed["embed"].shape[0], packed["wi"].shape[1]
    assert table.shape == (k, h3) and cond_table.shape == (batch, t_frames, h3)
    rng = np.random.default_rng(batch)
    for _ in range(4):
        prev = torch.from_numpy(rng.integers(0, k, batch))
        frame = int(rng.integers(0, t_frames))
        hoisted = table[prev] + cond_table[:, frame]
        step = (packed["embed"][prev] + cond[:, frame]) @ packed["wi"] + packed["bi"]
        np.testing.assert_allclose(hoisted.numpy(), step.numpy(), atol=1e-5, rtol=1e-5)
        hprev = torch.from_numpy(rng.normal(0, 0.5, (batch, h3 // 3)).astype(np.float32))
        gh = hprev @ packed["wh"] + packed["bh"]
        np.testing.assert_allclose(gru_update(hoisted, gh, hprev).numpy(),
                                   gru_update(step, gh, hprev).numpy(), atol=1e-6)


def _score_key(v: np.float32, idx: int) -> int:
    """csrc/wavernn_sample.cu::score_key in Python."""
    u = int(np.array(np.float32(v) + np.float32(0.0), np.float32).view(np.uint32))
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | (0xFFFFFFFF - idx)


def test_score_keys_order_as_argmax():
    """The largest key is torch.argmax's pick: the larger score, and on a
    tie the lower index (-0.0 and 0.0 tie); keys merge in any order."""
    rng = np.random.default_rng(5)
    for trial in range(50):
        scores = rng.normal(0, 3, 24).astype(np.float32)
        if trial % 3 == 0:
            scores[rng.integers(0, 24, 4)] = scores.max()        # ties at the top
        if trial % 5 == 0:
            scores[:] = 0.0
            scores[::2] = -0.0
        keys = [_score_key(v, i) for i, v in enumerate(scores)]
        best = max(keys[i] for i in rng.permutation(24))
        want = int(torch.argmax(torch.from_numpy(scores)))
        assert 0xFFFFFFFF - (best & 0xFFFFFFFF) == want


def test_sample_smem_fits_config_5():
    """K5's CTA on 132 SMs at gst_wavernn's widths (C = H = F = 512, K =
    256): 4 units, 4 fc1 columns, 4 classes a CTA, in one block's shared
    memory."""
    v = get_preset("gst_wavernn").model.vocoder
    c = h = v.wavernn_gru_dim
    assert v.wavernn_fc_dim == c
    smem = twavernn.sample_smem(c, h, c, 2 ** v.wavernn_bits, 132)
    assert smem == 189456 and smem <= 232448


def test_warp_products_reduce_scatter_covers_each_output_once():
    """csrc/wavernn_sample.cu::warp_products' shuffles, lane by lane: 32
    lanes' partial sums of 16 outputs, four halving exchanges (xor 16, 8,
    4, 2) and a final pair (xor 1); each even lane emits output idx(lane),
    every output exactly once, equal to the sum over the lanes."""
    rng = np.random.default_rng(3)
    part = rng.normal(0, 1, (32, 16))
    a = part.copy()
    lane = np.arange(32)
    for bit, half in ((16, 8), (8, 4), (4, 2), (2, 1)):
        hi = (lane & bit) != 0
        keep = np.where(hi[:, None], a[:, half:2 * half], a[:, :half])
        send = np.where(hi[:, None], a[:, :half], a[:, half:2 * half])
        a = keep + send[lane ^ bit]
    a = a[:, 0] + a[lane ^ 1, 0]
    idx = (8 * ((lane & 16) > 0) + 4 * ((lane & 8) > 0) + 2 * ((lane & 4) > 0)
           + ((lane & 2) > 0))
    even = lane % 2 == 0
    assert sorted(idx[even]) == list(range(16))
    np.testing.assert_allclose(a[even], part.sum(0)[idx[even]], rtol=1e-12)
    np.testing.assert_array_equal(a[even], a[lane[even] ^ 1])


def test_a_shards_samples_are_the_whole_batchs_rows():
    """``row0``: the Gumbel stream from row ``row0`` is those rows of the
    whole batch's (numpy and torch), and the plain sampler and
    ``score_gaps`` of rows 1..2 at ``row0=1`` give those rows of the call on
    all three rows (a data-parallel rank's rows)."""
    steps = np.arange(12)
    full = twavernn.gumbel_uniforms(7, steps, 4, 256)
    np.testing.assert_array_equal(twavernn.gumbel_uniforms(7, steps, 2, 256, row0=1),
                                  full[:, 1:3])
    np.testing.assert_array_equal(
        twavernn.gumbel_uniforms(7, torch.arange(12), 2, 256, row0=1).numpy(), full[:, 1:3])
    _, _, model, mel = build(t_frames=3, batch=3)
    packed = model.pack()
    with torch.no_grad():
        cond = model.cond_frames(torch.from_numpy(mel))
        kw = dict(hop=CFG_KW["wavernn_hop"], seed=5, temperature=0.7)
        whole = twavernn.wavernn_sample_plain(packed, cond, **kw)
        part = twavernn.wavernn_sample_plain(packed, cond[1:], row0=1, **kw)
        assert torch.equal(part, whole[1:])
        assert not torch.equal(twavernn.wavernn_sample_plain(packed, cond[1:], **kw), whole[1:])
        gaps = twavernn.score_gaps(packed, cond, whole, **kw)
        gaps_part = twavernn.score_gaps(packed, cond[1:], part, row0=1, **kw)
        torch.testing.assert_close(gaps_part, gaps[1:], atol=1e-5, rtol=0)
        assert float(gaps.abs().max()) < 1e-5
