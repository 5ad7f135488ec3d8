"""The port's copies of the config and text frontend agree with the JAX
package's: every preset and every configs/*.json gives the same config dict
(the port's own keys, ``PORT_ONLY``, at the values every JAX configuration
means; the port's own presets against their files), and text_to_ids gives
the same ids."""

from pathlib import Path

import numpy as np
import pytest

from gst_tacotron_tpu import config as jconfig
from gst_tacotron_tpu import text as jtext
from gst_tacotron_tpu_torch import config as tconfig
from gst_tacotron_tpu_torch import text as ttext

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_presets_match(name):
    assert sorted(set(tconfig.PRESETS) - set(tconfig.PORT_ONLY_PRESETS)) \
        == sorted(jconfig.PRESETS)
    assert (tconfig.to_jax_dict(tconfig.get_preset(name))
            == jconfig.to_dict(jconfig.get_preset(name)))


@pytest.mark.parametrize("path", sorted(CONFIG_DIR.glob("*.json")), ids=lambda p: p.name)
def test_config_files_match(path):
    if path.stem in tconfig.PORT_ONLY_PRESETS:
        # no JAX twin: the file is the port's preset as written
        assert (tconfig.to_dict(tconfig.load_config(str(path)))
                == tconfig.to_dict(tconfig.get_preset(path.stem)))
        return
    assert tconfig.to_jax_dict(tconfig.load_config(str(path))) == jconfig.to_dict(
        jconfig.load_config(str(path)))


def test_overrides_match():
    ov = {"model.decoder.max_decode_steps": 200, "audio.griffin_lim_iters": 15,
          "model.gst.ref_conv_channels": [4, 8]}
    t = tconfig.apply_overrides(tconfig.get_preset("gst_lj"), ov)
    j = jconfig.apply_overrides(jconfig.get_preset("gst_lj"), ov)
    assert tconfig.to_jax_dict(t) == jconfig.to_dict(j)
    with pytest.raises(ValueError, match="no such module"):
        tconfig.to_jax_dict(tconfig.get_preset("gst_taco2"))
    with pytest.raises(KeyError):
        tconfig.apply_overrides(t, {"model.decoder.nope": 1})


SENTENCES = [
    "Dr. Smith paid $3.50 for 2 coffees on the 21st.",
    "In 1984, Mrs. Jones moved to St. Louis with 1,250 books.",
    "Capt. Hook's crew: 12 pirates, 3.14 parrots & £20!",
    "Ünïcödé   whitespace\tand   MIXED case.",
]


@pytest.mark.parametrize("sentence", SENTENCES)
def test_text_to_ids_matches(sentence):
    assert ttext.text_to_ids(sentence) == jtext.text_to_ids(sentence)


def test_batch_text_to_ids_matches():
    for max_len in (None, 12):
        t_ids, t_len = ttext.batch_text_to_ids(SENTENCES, max_len=max_len)
        j_ids, j_len = jtext.batch_text_to_ids(SENTENCES, max_len=max_len)
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_len, j_len)
