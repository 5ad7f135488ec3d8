"""One-way Keras/TF2 checkpoint importer (counterpart of
``gst_tacotron_tpu/tf_import.py``, of which this is the port's own copy).

Reads a TF checkpoint with ``tf.train.load_checkpoint`` (TensorFlow is
imported only there, so the package imports without it) and converts the
Keras layouts to the JAX package's variables:

  * Keras GRU (v2, reset_after=True): kernel (D, 3H), recurrent_kernel
    (H, 3H), gate order [z, r, n] carry over; the (2, 3H) bias splits into
    ``bias`` (input) and ``recurrent_bias``;
  * Keras Dense/Conv kernels are already (in, out) / (k, in, out) /
    (kh, kw, in, out);
  * Keras BatchNorm {gamma, beta, moving_mean, moving_variance} ->
    ``params`` {scale, bias} and ``batch_stats`` {mean, var};
  * a bank of K Conv1D kernels -> the conv bank's fused ``bank_kernel``.

The whole-model importers (``import_checkpoint``, ``import_gst_tacotron``,
``import_reference_encoder``) return the FLAT mapping ``weights.load_flat``
takes: numpy arrays keyed ``params/<flax path>`` and
``batch_stats/<flax path>``. The grouped helpers (``keras_gru_params``,
``keras_bn_params``, ``import_cbhg``) return nested subtrees as the JAX
package's do. The naming convention of a full checkpoint is the export of
``tests/keras_ref_model.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

_ATTR = "/.ATTRIBUTES/VARIABLE_VALUE"
_COLLECTIONS = ("params/", "batch_stats/")


def convert_keras_gru(kernel: np.ndarray, recurrent_kernel: np.ndarray,
                      bias: np.ndarray) -> Dict[str, np.ndarray]:
    """Keras v2 GRU variables -> the GRU cell's parameters (reset_after)."""
    if bias.ndim == 2:  # (2, 3H): [input bias, recurrent bias]
        input_bias, recurrent_bias = bias[0], bias[1]
    else:  # reset_after=False checkpoints: one fused bias
        input_bias, recurrent_bias = bias, np.zeros_like(bias)
    return {"kernel": kernel, "recurrent_kernel": recurrent_kernel,
            "bias": input_bias, "recurrent_bias": recurrent_bias}


def convert_keras_batchnorm(gamma, beta, moving_mean, moving_variance
                            ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """-> (params {scale, bias}, batch_stats {mean, var})."""
    return {"scale": gamma, "bias": beta}, {"mean": moving_mean, "var": moving_variance}


def load_tf_checkpoint_arrays(ckpt_path: str) -> Dict[str, np.ndarray]:
    """All variables of a TF checkpoint as {name: np.ndarray}."""
    import tensorflow as tf  # an import-time dependency of this function only

    reader = tf.train.load_checkpoint(ckpt_path)
    return {name: reader.get_tensor(name) for name in reader.get_variable_to_shape_map()}


def set_in_tree(tree: Dict[str, Any], path: str, value: np.ndarray) -> None:
    """Put ``value`` at the '/'-separated ``path`` of a nested dict."""
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def flatten(tree: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """A nested dict of arrays -> {``prefix``/path: array}."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(flatten(v, f"{prefix}/{k}"))
        else:
            flat[f"{prefix}/{k}"] = np.asarray(v)
    return flat


def import_checkpoint(ckpt_path: str, name_map: Mapping[str, str]) -> Dict[str, np.ndarray]:
    """The flat variables named by ``name_map`` ({TF variable name: our
    '/'-separated path}); a path without a collection is a parameter
    (``params/`` is prepended). Grouped conversions (GRU, BatchNorm) go
    through ``keras_gru_params`` / ``keras_bn_params`` instead."""
    arrays = load_tf_checkpoint_arrays(ckpt_path)
    flat: Dict[str, np.ndarray] = {}
    for tf_name, our_path in name_map.items():
        if tf_name not in arrays:
            raise KeyError(f"variable {tf_name!r} not in checkpoint")
        key = our_path if our_path.startswith(_COLLECTIONS) else f"params/{our_path}"
        flat[key] = np.asarray(arrays[tf_name])
    return flat


# ---------------------------------------------------------------------------
# Keras object-graph checkpoint helpers
# ---------------------------------------------------------------------------


def keras_variable(arrays: Mapping[str, np.ndarray], prefix: str, name: str) -> np.ndarray:
    """``<prefix>/<name>/.ATTRIBUTES/VARIABLE_VALUE`` of a loaded
    ``tf.train.Checkpoint`` (the object-graph naming), or Keras 3's private
    ``_<leaf>`` name for it (a Conv2D's kernel is ``_kernel``)."""
    key = f"{prefix}/{name}{_ATTR}"
    if key in arrays:
        return arrays[key]
    head, _, leaf = name.rpartition("/")
    alt = f"{prefix}/{head + '/' if head else ''}_{leaf}{_ATTR}"
    if alt in arrays:
        return arrays[alt]
    close = sorted(k for k in arrays if k.startswith(prefix))
    raise KeyError(f"{key!r} not in checkpoint; variables under the prefix: {close}")


def keras_gru_params(arrays: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """The Keras GRU layer at ``prefix`` (its cell's variables, or the
    layer's own) -> a GRU's parameter subtree."""
    try:
        names = [keras_variable(arrays, prefix, f"cell/{n}")
                 for n in ("kernel", "recurrent_kernel", "bias")]
    except KeyError:
        names = [keras_variable(arrays, prefix, n)
                 for n in ("kernel", "recurrent_kernel", "bias")]
    return convert_keras_gru(*names)


def keras_bn_params(arrays: Mapping[str, np.ndarray], prefix: str
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The Keras BatchNormalization at ``prefix`` -> (params, batch_stats)."""
    return convert_keras_batchnorm(*(keras_variable(arrays, prefix, n) for n in
                                     ("gamma", "beta", "moving_mean", "moving_variance")))


def convert_conv_bank(kernels) -> np.ndarray:
    """K Keras Conv1D SAME kernels (widths 1..K, each (k, C_in, C_out)) ->
    the ``ConvBankBlock.bank_kernel`` block matrix (nshift*C_in, K*C_out):
    tap j of the width-k conv reads x[t + j - (k-1)//2], so it lands in the
    block of shift s = j - (k-1)//2."""
    bank_k = len(kernels)
    c_in, channels = kernels[0].shape[1], kernels[0].shape[2]
    smin, smax = -((bank_k - 1) // 2), bank_k // 2
    nshift = smax - smin + 1
    w4 = np.zeros((nshift, c_in, bank_k, channels), np.float32)
    for k in range(1, bank_k + 1):
        kern = np.asarray(kernels[k - 1], np.float32)
        if kern.shape != (k, c_in, channels):
            raise ValueError(f"bank conv {k}: kernel shape {kern.shape}, expected "
                             f"{(k, c_in, channels)}")
        for j in range(k):
            w4[j - (k - 1) // 2 - smin, :, k - 1, :] = kern[j]
    return w4.reshape(nshift * c_in, bank_k * channels)


def _dense(arrays, prefix, use_bias=True) -> Dict[str, np.ndarray]:
    p = {"kernel": keras_variable(arrays, prefix, "kernel")}
    if use_bias:
        p["bias"] = keras_variable(arrays, prefix, "bias")
    return p


def import_cbhg(arrays: Mapping[str, np.ndarray], prefix: str, bank_k: int,
                num_projs: int, num_highways: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The Keras CBHG at ``prefix`` (``tests/keras_ref_model.py::KerasCBHG``'s
    export) -> (params, batch_stats) subtrees of a ``CBHG``."""
    params: Dict[str, Any] = {"bank": {"bank_kernel": convert_conv_bank([
        keras_variable(arrays, f"{prefix}/bank_conv_{k}", "kernel") for k in range(bank_k)])}}
    stats: Dict[str, Any] = {}
    params["bank"]["bn"], bn_s = keras_bn_params(arrays, f"{prefix}/bank_bn")
    stats["bank"] = {"bn": bn_s}
    for i in range(num_projs):
        params[f"proj_{i}"] = {"kernel": keras_variable(arrays, f"{prefix}/proj_{i}", "kernel")}
        params[f"proj_bn_{i}"], stats[f"proj_bn_{i}"] = keras_bn_params(
            arrays, f"{prefix}/proj_bn_{i}")
    for opt in ("residual_proj", "pre_highway"):
        if (f"{prefix}/{opt}/kernel{_ATTR}" in arrays
                or f"{prefix}/{opt}/_kernel{_ATTR}" in arrays):
            params[opt] = _dense(arrays, f"{prefix}/{opt}")
    for i in range(num_highways):
        params[f"highway_{i}"] = {g: _dense(arrays, f"{prefix}/highway_{i}_{g}")
                                  for g in ("h", "t")}
    params["bigru"] = {"forward": keras_gru_params(arrays, f"{prefix}/gru_fwd"),
                       "backward": keras_gru_params(arrays, f"{prefix}/gru_bwd")}
    return params, stats


def import_gst_tacotron(ckpt_path: str, cfg) -> Dict[str, np.ndarray]:
    """A full reference-architecture checkpoint (the export of
    ``tests/keras_ref_model.py::KerasGSTTacotron.save_checkpoint``) -> the
    flat variables of the whole ``GSTTacotron``. ``cfg`` is the
    ``ModelConfig``: layer counts and kinds come from it, so one importer
    covers both attention kinds and both CBHGs. The export has the taco1
    encoder; a taco2 config is refused."""
    if cfg.encoder.kind != "taco1":
        raise ValueError(f"the Keras export holds a taco1 encoder, not {cfg.encoder.kind!r}")
    arrays = load_tf_checkpoint_arrays(ckpt_path)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    cb_p, cb_s = import_cbhg(arrays, "encoder/cbhg", cfg.encoder.cbhg_bank_k,
                             len(cfg.encoder.cbhg_proj_channels),
                             cfg.encoder.cbhg_highway_layers)
    params["encoder"] = {
        "embedding": {"embedding": keras_variable(arrays, "encoder/embedding", "embeddings")},
        "prenet": {f"dense_{i}": _dense(arrays, f"encoder/prenet_{i}")
                   for i in range(len(cfg.encoder.prenet_dims))},
        "cbhg": cb_p}
    stats["encoder"] = {"cbhg": cb_s}

    if cfg.gst.enabled:
        ref_p: Dict[str, Any] = {}
        ref_s: Dict[str, Any] = {}
        for i in range(len(cfg.gst.ref_conv_channels)):
            ref_p[f"conv_{i}"] = {"kernel": keras_variable(arrays, f"gst/ref_conv_{i}",
                                                           "kernel")}
            ref_p[f"bn_{i}"], ref_s[f"bn_{i}"] = keras_bn_params(arrays, f"gst/ref_bn_{i}")
        ref_p["gru"] = keras_gru_params(arrays, "gst/ref_gru")
        params["gst"] = {
            "reference_encoder": ref_p,
            "stl": {"tokens": arrays[f"gst/tokens{_ATTR}"],
                    **{f"{n}_proj": _dense(arrays, f"gst/stl_{n[0]}", use_bias=False)
                       for n in ("query", "key", "value")}}}
        stats["gst"] = {"reference_encoder": ref_s}

    attn_p: Dict[str, Any] = {
        "query_proj": _dense(arrays, "decoder/attn_query", use_bias=False),
        "memory_proj": _dense(arrays, "decoder/attn_memory", use_bias=False),
        "score_v": _dense(arrays, "decoder/attn_v", use_bias=False)}
    if cfg.attention.kind == "location_sensitive":
        attn_p["location_conv"] = {"kernel": keras_variable(arrays, "decoder/loc_conv",
                                                            "kernel")}
        attn_p["location_proj"] = _dense(arrays, "decoder/loc_proj", use_bias=False)
    cell_p: Dict[str, Any] = {
        "prenet": {f"dense_{i}": _dense(arrays, f"decoder/prenet_{i}")
                   for i in range(len(cfg.decoder.prenet_dims))},
        "attention_rnn": keras_gru_params(arrays, "decoder/attention_rnn"),
        "attention": attn_p,
        "decoder_input_proj": _dense(arrays, "decoder/dec_input_proj"),
        "frame_proj": _dense(arrays, "decoder/frame_proj"),
        "stop_proj": _dense(arrays, "decoder/stop_proj")}
    for i in range(cfg.decoder.num_decoder_rnn_layers):
        cell_p[f"decoder_rnn_{i}"] = keras_gru_params(arrays, f"decoder/rnn_{i}")
    params["decoder"] = {"cell": cell_p}

    po_p, po_s = import_cbhg(arrays, "postnet/cbhg", cfg.postnet.cbhg_bank_k,
                             len(cfg.postnet.cbhg_proj_channels),
                             cfg.postnet.cbhg_highway_layers)
    params["postnet"] = {"cbhg": po_p, "linear_proj": _dense(arrays, "postnet/linear")}
    stats["postnet"] = {"cbhg": po_s}
    return {**flatten(params, "params"), **flatten(stats, "batch_stats")}


def import_reference_encoder(ckpt_path: str, num_conv_layers: int,
                             conv_prefix: str = "conv", bn_prefix: str = "bn",
                             gru_prefix: str = "gru") -> Dict[str, np.ndarray]:
    """A Keras reference encoder (conv2d-s2 stack + BN + GRU) saved as
    ``tf.train.Checkpoint(conv0=..., bn0=..., ..., gru=...)`` -> the flat
    variables of a ``ReferenceEncoder``."""
    arrays = load_tf_checkpoint_arrays(ckpt_path)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(num_conv_layers):
        params[f"conv_{i}"] = {"kernel": keras_variable(arrays, f"{conv_prefix}{i}", "kernel")}
        params[f"bn_{i}"], stats[f"bn_{i}"] = keras_bn_params(arrays, f"{bn_prefix}{i}")
    params["gru"] = keras_gru_params(arrays, gru_prefix)
    return {**flatten(params, "params"), **flatten(stats, "batch_stats")}
