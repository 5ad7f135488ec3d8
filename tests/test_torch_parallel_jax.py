"""The port's data-parallel path against the JAX package's on the CPU:
two gloo ranks of the port (``tests/torch_dist_workers.py``) against JAX on
a 2-device mesh (``make_mesh(1, devices=jax.devices()[:2])``;
tests/conftest.py gives the test process 8 CPU devices), small_cfg's
gst_lj widths, prenet dropout 0 on both sides (jax.random's masks cannot be
reproduced), the JAX init carried over by ``weights.load_flat``:

* one dp=2 train step against the JAX ``Trainer``'s step
  (``make_train_step`` under the mesh, the batch sharded over ``data``) on
  a global batch whose two shards have very different valid lengths, at
  tests/test_torch_train_parity.py's budgets: each loss term and
  ``grad_norm`` within 1e-4 relative, parameters and running statistics
  within 5e-5. Averaging per-rank losses (a DDP-style step) misses the
  masked means' global denominators here.

tests/test_torch_parallel_jax_synth.py holds ``DistributedSynthesizer``
against the JAX one on the same setup.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.config import save_config
from gst_tacotron_tpu.parallel import make_mesh as jmake_mesh
from gst_tacotron_tpu.parallel import shard_batch as jshard_batch
from gst_tacotron_tpu.train import TrainState as JTrainState
from gst_tacotron_tpu.train import _model_kwargs as j_model_kwargs
from gst_tacotron_tpu.train import build_model as jbuild
from gst_tacotron_tpu.train import make_optimizer as jmake_optimizer
from gst_tacotron_tpu.train import make_train_step as jmake_train_step
from gst_tacotron_tpu_torch.config import load_config
from gst_tacotron_tpu_torch.weights import state_key_to_flat

from tests.test_torch_synth_configs import flatten_tree
from tests.test_train_smoke import small_cfg
from tests.torch_dist_workers import run_ranks

torch.set_num_threads(2)

NO_DROPOUT = {"model.encoder.prenet_dropout": 0.0, "model.decoder.prenet_dropout": 0.0,
              "optimizer.schedule": "constant", "optimizer.learning_rate": 1e-3,
              "model.decoder.stop_threshold": 1.0}
LOSS_RTOL = 1e-4
STATE_ATOL = 5e-5
B, T_TEXT, T_MEL = 4, 14, 16


def unequal_batch(rng, num_freq):
    """Rank 0's rows (0, 1) near full length, rank 1's (2, 3) short; no
    symbol twice in a row (tests/test_torch_train_parity.py::make_batch)."""
    tl, ml = np.array([T_TEXT, T_TEXT - 1, 4, 3]), np.array([T_MEL, T_MEL - 2, 4, 6])
    tmask = np.arange(T_TEXT)[None] < tl[:, None]
    fmask = (np.arange(T_MEL)[None] < ml[:, None])[..., None]
    steps = rng.integers(1, 39, (B, T_TEXT))
    tokens = 1 + (rng.integers(0, 39, (B, 1)) + np.cumsum(steps, 1)) % 39
    return {"tokens": (tokens * tmask).astype(np.int32), "token_lengths": tl.astype(np.int32),
            "mel": (rng.uniform(0, 1, (B, T_MEL, 80)) * fmask).astype(np.float32),
            "mel_lengths": ml.astype(np.int32),
            "linear": (rng.uniform(0, 1, (B, T_MEL, num_freq)) * fmask).astype(np.float32),
            "speaker_ids": np.zeros(B, np.int32)}


def jax_setup(tmp_path_factory):
    """Both packages' configs, the global batch, the JAX model and its
    train state, the flat variables, the 2-device mesh."""
    jcfg = small_cfg("gst_lj", **NO_DROPOUT)
    path = str(tmp_path_factory.mktemp("cfg") / "config.json")
    save_config(jcfg, path)
    batch = unequal_batch(np.random.default_rng(0), jcfg.model.num_freq)
    # train.init_state's state, its init jitted
    model = jbuild(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(0)}, jb["tokens"],
        jb["token_lengths"], jb["mel"], train=False, **j_model_kwargs(jcfg, jb)))()
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"],
                        opt_state=jmake_optimizer(jcfg.optimizer).init(variables["params"]),
                        rng=jax.random.PRNGKey(4))
    flat = flatten_tree(variables)
    return dict(jcfg=jcfg, cfg=load_config(path), batch=batch, model=model, state=state,
                flat=flat, mesh=jmake_mesh(1, devices=jax.devices()[:2]))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return jax_setup(tmp_path_factory)


def test_data_parallel_step_matches_the_jax_trainer(setup):
    jcfg, batch, mesh = setup["jcfg"], setup["batch"], setup["mesh"]
    tx = jmake_optimizer(jcfg.optimizer)
    step = jmake_train_step(setup["model"], tx, jcfg, mesh, donate=False)
    jstate, jmetrics = step(setup["state"], jshard_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    ref = {k: float(v) for k, v in jmetrics.items()}
    after = flatten_tree({"params": jstate.params, "batch_stats": jstate.batch_stats})
    tbatch = {k: v.astype(np.int64) if v.dtype == np.int32 else v for k, v in batch.items()}
    got = run_ranks("train_steps", 2, setup["cfg"], (1,), [tbatch], setup["flat"])[0][0]
    assert ref.keys() == got["metrics"][0].keys()
    for k, v in ref.items():
        np.testing.assert_allclose(got["metrics"][0][k], v, rtol=LOSS_RTOL, err_msg=k)
    flat_key = lambda k: (state_key_to_flat(k, "batch_stats")
                          if state_key_to_flat(k, "batch_stats") in after
                          else state_key_to_flat(k))
    mine = {flat_key(k): v for k, v in got["model"].items()}
    assert mine.keys() == after.keys()
    for k, v in after.items():
        np.testing.assert_allclose(mine[k], v, atol=STATE_ATOL, rtol=0, err_msg=k)
