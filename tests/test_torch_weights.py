"""``weights.export_flat``, the inverse of ``load_flat``: at the small widths
of tests/test_train_smoke.py::small_cfg, the exported names are the JAX
variables' flat names (parameters and batch statistics), and
``load_flat(export_flat(m))`` reproduces every tensor of ``m`` bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.models.wavernn import WaveRNN as JWaveRNN
from gst_tacotron_tpu.train import build_model as jbuild
from gst_tacotron_tpu_torch.weights import (build_model, build_wavernn, export_flat,
                                            flat_key_to_state_key, load_flat,
                                            state_key_to_flat)

from tests.test_torch_synth_configs import flatten_tree
from tests.test_torch_train_parity import load_config_from_jax
from tests.test_train_smoke import small_cfg

torch.set_num_threads(2)

CONFIGS = {"gst_lj": {}, "gst_r1_location": {"model.attention.location_filters": 4},
           "gst_multispeaker": {"model.num_speakers": 3, "model.speaker_dim": 8},
           "taco1_lj": {}}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_export_flat_names_and_round_trip(name):
    jcfg = small_cfg(name, **CONFIGS[name])
    cfg = load_config_from_jax(jcfg)
    model = jbuild(jcfg)
    kwargs = {}
    if jcfg.model.gst.enabled:
        kwargs = {"ref_mel": jnp.zeros((1, 16, 80)), "ref_mel_lengths": jnp.array([16])}
    if jcfg.model.num_speakers > 1:
        kwargs["speaker_ids"] = jnp.zeros((1,), jnp.int32)
    variables = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 8), jnp.int32), jnp.array([8]), jnp.zeros((1, 16, 80)), **kwargs))()
    flat = flatten_tree({"params": variables["params"],
                         "batch_stats": variables["batch_stats"]})
    mine = build_model(cfg, seed=3, device="cpu")
    exported = export_flat(mine)
    assert exported.keys() == flat.keys()
    for key, value in exported.items():
        assert value.shape == flat[key].shape and value.dtype == np.float32, key
        assert state_key_to_flat(flat_key_to_state_key(key), key.split("/")[0]) == key

    other = build_model(cfg, seed=4, device="cpu")
    load_flat(other, exported)
    a, b = mine.state_dict(), other.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_export_flat_wavernn():
    jcfg = small_cfg("gst_wavernn", **{"model.vocoder.wavernn_gru_dim": 8,
                                       "model.vocoder.wavernn_fc_dim": 8})
    cfg = load_config_from_jax(jcfg)
    jvoc = JWaveRNN(jcfg.model.vocoder, 80)
    hop = jcfg.model.vocoder.wavernn_hop
    vars_ = jvoc.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 80)), jnp.zeros((1, 2 * hop)))
    mine = build_wavernn(cfg, seed=1, device="cpu")
    exported = export_flat(mine)
    assert exported.keys() == flatten_tree({"params": vars_["params"]}).keys()
    other = build_wavernn(cfg, seed=2, device="cpu")
    load_flat(other, exported)
    for k, v in mine.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k
