"""The slice at full gst_lj width on the CPU: the JAX seeded init of the
golden_prod fixture carried across by ``weights.py``, one golden_prod text
through both Synthesizers at ``deterministic_prenet=True``, within the
golden gate's budgets (see test_torch_synth.py)."""

import os
import sys

import jax
import numpy as np
import torch

from gst_tacotron_tpu.config import apply_overrides as japply
from gst_tacotron_tpu.config import load_config as jload
from gst_tacotron_tpu.synthesize import Synthesizer as JSynthesizer
from gst_tacotron_tpu.train import build_model as jbuild
from gst_tacotron_tpu_torch.config import apply_overrides, load_config
from gst_tacotron_tpu_torch.synthesize import Synthesizer
from gst_tacotron_tpu_torch.weights import build_model

from tests.test_torch_synth import assert_slice_close

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "tools"))
from make_golden_fixtures import _prod_init_variables, flatten_tree  # noqa: E402

torch.set_num_threads(2)

PROD = os.path.join(os.path.dirname(__file__), "fixtures", "golden_prod")


def test_golden_prod_text_matches_jax_synthesizer():
    jcfg = japply(jload(os.path.join(PROD, "config.json")), {"audio.griffin_lim_bf16": False})
    # the fixture's seeded init, traced once (eager flax init of the full
    # model takes several times longer)
    variables = jax.jit(lambda: _prod_init_variables(jcfg)[1])()
    model = jbuild(jcfg)
    flat = flatten_tree({"params": variables["params"],
                         "batch_stats": variables["batch_stats"]})
    with np.load(os.path.join(PROD, "text_0.npz")) as z:
        text = str(z["text"])
    ref = JSynthesizer(jcfg, model, variables, deterministic_prenet=True)([text], seed=0)
    cfg = apply_overrides(load_config(os.path.join(PROD, "config.json")),
                          {"audio.griffin_lim_bf16": False})
    ts = Synthesizer(cfg, build_model(cfg, flat=flat, device="cpu"), device="cpu",
                     deterministic_prenet=True)
    got = ts([text], seed=0)
    assert got["mel"].shape == ref["mel"].shape == (1, 24, 80)
    assert got["linear"].shape[-1] == 1025
    assert_slice_close(got, ref)
