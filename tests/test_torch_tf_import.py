"""The port's Keras/TF2 checkpoint importer (``gst_tacotron_tpu_torch/
tf_import.py``) against the JAX package's (``gst_tacotron_tpu/tf_import.py``)
on the real ``tf.keras`` checkpoints of tests/test_tf_parity.py and
tests/test_tf_parity_full.py: the flat arrays it returns equal the JAX
importer's (flattened) exactly, and the port's modules loaded from them
(``weights.load_flat``) match Keras's forward within those tests' budgets:
GRU cell, sequence and masked final state 1e-5, Conv1D and 3x3/2 Conv2D
SAME 1e-5, BatchNorm at inference 1e-5, the reference encoder 2e-4, and
the whole GSTTacotron teacher-forced (alignments 2e-5, stop logits and mel
5e-5, linear 2e-4) for Bahdanau and location-sensitive attention."""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from gst_tacotron_tpu import tf_import as jti  # noqa: E402
from gst_tacotron_tpu_torch import tf_import as tti  # noqa: E402
from gst_tacotron_tpu_torch.config import GSTConfig, load_config  # noqa: E402
from gst_tacotron_tpu_torch.models.gst import ReferenceEncoder  # noqa: E402
from gst_tacotron_tpu_torch.models.modules import (BN_EPS, BatchNorm,  # noqa: E402
                                                   MatmulConv1D, MatmulConv2DStride2)
from gst_tacotron_tpu_torch.models.rnn import GRU, GRUCell  # noqa: E402
from gst_tacotron_tpu_torch.weights import build_model, load_flat  # noqa: E402

from tests.test_torch_synth_configs import flatten_tree  # noqa: E402

torch.set_num_threads(2)

RNG = np.random.default_rng(42)


def _save(tmp_path, **trackables) -> str:
    return tf.train.Checkpoint(**trackables).save(str(tmp_path / "ck"))


def assert_same_arrays(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def gru_flat(path):
    """The port's and the JAX importer's GRU variables, flat and equal."""
    got = tti.flatten(tti.keras_gru_params(tti.load_tf_checkpoint_arrays(path), "gru"),
                      "params")
    ref = flatten_tree({"params": jti.keras_gru_params(jti.load_tf_checkpoint_arrays(path),
                                                       "gru")})
    assert_same_arrays(got, ref)
    return got


def test_pure_conversions_match_jax():
    rng = np.random.default_rng(0)
    k, rk, b = (rng.standard_normal(s).astype(np.float32) for s in ((3, 12), (4, 12), (2, 12)))
    for bias in (b, b[0]):
        assert_same_arrays(tti.convert_keras_gru(k, rk, bias), jti.convert_keras_gru(k, rk, bias))
    bn = [rng.standard_normal(4) for _ in range(4)]
    for got, ref in zip(tti.convert_keras_batchnorm(*bn), jti.convert_keras_batchnorm(*bn)):
        assert_same_arrays(got, ref)
    kernels = [rng.standard_normal((w, 3, 5)).astype(np.float32) for w in range(1, 6)]
    np.testing.assert_array_equal(tti.convert_conv_bank(kernels), jti.convert_conv_bank(kernels))
    tree = {}
    tti.set_in_tree(tree, "a/b/c", np.zeros(2))
    tti.set_in_tree(tree, "a/b/d", np.ones(2))
    assert set(tree["a"]["b"]) == {"c", "d"}


def test_keras_gru_cell_and_sequences(tmp_path):
    d, h, b, t = 4, 6, 3, 9
    lengths = np.array([5, 9, 2])
    layer = tf.keras.layers.GRU(h, reset_after=True, return_sequences=True, return_state=True)
    x = RNG.standard_normal((b, t, d)).astype(np.float32)
    h0 = RNG.standard_normal((b, h)).astype(np.float32)
    ys_tf, final_tf = layer(x)
    mask = tf.constant(np.arange(t)[None, :] < lengths[:, None])
    _, masked_tf = layer(x, mask=mask)
    step_tf = layer(x[:, :1], initial_state=tf.constant(h0))[1]
    flat = gru_flat(_save(tmp_path, gru=layer))
    gru, cell = GRU(d, h), GRUCell(d, h)
    load_flat(gru, flat)
    load_flat(cell, flat)
    with torch.no_grad():
        ys, final = gru(torch.from_numpy(x), plain=True)
        _, masked = gru(torch.from_numpy(x), torch.from_numpy(lengths), plain=True)
        step, _ = cell(torch.from_numpy(h0), torch.from_numpy(x[:, 0]))
    for got, ref in ((ys, ys_tf), (final, final_tf), (masked, masked_tf), (step, step_tf)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("t,k", [(12, 3), (11, 5), (7, 31)])
def test_keras_conv1d_same(tmp_path, t, k):
    c_in, c_out, b = 3, 4, 2
    layer = tf.keras.layers.Conv1D(c_out, k, padding="same", use_bias=True)
    x = RNG.standard_normal((b, t, c_in)).astype(np.float32)
    expected = layer(x).numpy()
    names = {"conv/_kernel/.ATTRIBUTES/VARIABLE_VALUE": "kernel",
             "conv/bias/.ATTRIBUTES/VARIABLE_VALUE": "bias"}
    path = _save(tmp_path, conv=layer)
    flat = tti.import_checkpoint(path, names)
    assert_same_arrays(flat, flatten_tree({"params": jti.import_checkpoint(path, names)}))
    conv = MatmulConv1D(c_in, c_out, k)
    load_flat(conv, {"params/kernel": flat["params/kernel"]})
    got = conv(torch.from_numpy(x)).detach().numpy() + flat["params/bias"]
    np.testing.assert_allclose(got, expected, atol=1e-5)


@pytest.mark.parametrize("h,w", [(12, 16), (11, 15), (5, 6)])
def test_keras_conv2d_stride2_same(tmp_path, h, w):
    c_in, c_out, b = 2, 3, 2
    layer = tf.keras.layers.Conv2D(c_out, 3, strides=2, padding="same", use_bias=False)
    x = RNG.standard_normal((b, h, w, c_in)).astype(np.float32)
    expected = layer(x).numpy()
    names = {"conv/_kernel/.ATTRIBUTES/VARIABLE_VALUE": "params/kernel"}
    path = _save(tmp_path, conv=layer)
    flat = tti.import_checkpoint(path, names)
    assert_same_arrays(flat, flatten_tree({"params": jti.import_checkpoint(
        path, {k: "kernel" for k in names})}))
    conv = MatmulConv2DStride2(c_in, c_out)
    load_flat(conv, flat)
    np.testing.assert_allclose(conv(torch.from_numpy(x)).detach().numpy(), expected, atol=1e-5)


def test_keras_batchnorm_inference(tmp_path):
    c, b = 5, 4
    layer = tf.keras.layers.BatchNormalization()
    layer.build((None, c))
    layer.gamma.assign(RNG.uniform(0.5, 2.0, c).astype(np.float32))
    layer.beta.assign(RNG.standard_normal(c).astype(np.float32))
    layer.moving_mean.assign(RNG.standard_normal(c).astype(np.float32))
    layer.moving_variance.assign(RNG.uniform(0.1, 3.0, c).astype(np.float32))
    x = RNG.standard_normal((b, c)).astype(np.float32)
    expected = layer(x, training=False).numpy()
    path = _save(tmp_path, bn=layer)
    p, s = tti.keras_bn_params(tti.load_tf_checkpoint_arrays(path), "bn")
    jp, js = jti.keras_bn_params(jti.load_tf_checkpoint_arrays(path), "bn")
    assert_same_arrays(p, jp)
    assert_same_arrays(s, js)
    bn = BatchNorm(c, eps=BN_EPS)
    load_flat(bn, {**tti.flatten(p, "params"), **tti.flatten(s, "batch_stats")})
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(), expected, atol=1e-5)


def test_reference_encoder_import_end_to_end(tmp_path):
    from tests.test_tf_parity import _keras_reference_encoder

    channels = (4, 4, 8)
    gru_dim, num_mels, b, t = 6, 16, 2, 21
    convs, bns, gru, forward = _keras_reference_encoder(channels, gru_dim)
    mel = RNG.standard_normal((b, t, num_mels)).astype(np.float32)
    forward(mel)
    for bn in bns:
        bn.moving_mean.assign(RNG.standard_normal(bn.moving_mean.shape).astype(np.float32) * 0.3)
        bn.moving_variance.assign(
            RNG.uniform(0.5, 2.0, bn.moving_variance.shape).astype(np.float32))
    expected = forward(mel)
    trackables = {f"conv{i}": c for i, c in enumerate(convs)}
    trackables.update({f"bn{i}": bn for i, bn in enumerate(bns)})
    trackables["gru"] = gru
    path = _save(tmp_path, **trackables)
    flat = tti.import_reference_encoder(path, len(channels))
    assert_same_arrays(flat, flatten_tree(jti.import_reference_encoder(path, len(channels))))
    enc = ReferenceEncoder(GSTConfig(ref_conv_channels=channels, ref_gru_dim=gru_dim), num_mels)
    load_flat(enc, flat)
    with torch.no_grad():
        got = enc(torch.from_numpy(mel), plain=True)
    np.testing.assert_allclose(got.numpy(), expected, atol=2e-4)


@pytest.mark.parametrize("attention_kind,with_residual_proj",
                         [("bahdanau", False), ("location_sensitive", True)])
def test_full_model_import_and_teacher_forced_parity(tmp_path, attention_kind,
                                                     with_residual_proj):
    from gst_tacotron_tpu.config import save_config

    from tests.test_tf_parity_full import NUM_MELS, NUM_SYMBOLS, build_keras, tiny_cfg

    rng = np.random.default_rng(3 if attention_kind == "bahdanau" else 4)
    jcfg = tiny_cfg(attention_kind, with_residual_proj)
    save_config(jcfg, str(tmp_path / "config.json"))
    cfg = load_config(str(tmp_path / "config.json"))
    b, t_text, t_mel, t_ref = 2, 13, 10, 9
    tokens = rng.integers(1, NUM_SYMBOLS, (b, t_text)).astype(np.int32)
    mel_targets = rng.normal(0, 1.0, (b, t_mel, NUM_MELS)).astype(np.float32)
    ref_mel = rng.normal(0, 1.0, (b, t_ref, NUM_MELS)).astype(np.float32)
    keras_model = build_keras(jcfg)
    keras_model(tf.constant(tokens), tf.constant(mel_targets), tf.constant(ref_mel))
    keras_model.randomize(rng)
    expected = keras_model(tf.constant(tokens), tf.constant(mel_targets), tf.constant(ref_mel))
    path = keras_model.save_checkpoint(tmp_path / "ref_ck")
    flat = tti.import_gst_tacotron(path, cfg.model)
    assert_same_arrays(flat, flatten_tree(jti.import_gst_tacotron(path, jcfg.model)))
    model = build_model(cfg, flat=flat, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long(), None, torch.from_numpy(mel_targets),
                    ref_mel=torch.from_numpy(ref_mel), deterministic_prenet=True)
    for key, atol in (("alignments", 2e-5), ("stop_logits", 5e-5), ("mel", 5e-5),
                      ("linear", 2e-4)):
        np.testing.assert_allclose(out[key].numpy(), expected[key], atol=atol, err_msg=key)


def test_full_model_importer_refuses_a_taco2_config(tmp_path):
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset

    cfg = apply_overrides(get_preset("gst_lj"), {"model.encoder.kind": "taco2"})
    with pytest.raises(ValueError, match="taco1"):
        tti.import_gst_tacotron(str(tmp_path / "none"), cfg.model)
