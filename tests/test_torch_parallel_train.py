"""Data- and tensor-parallel train steps of the port on the CPU: two gloo
ranks (``tests/torch_dist_workers.py``) step under a (2, 1) mesh and under
a (1, 2) mesh, small_cfg's gst_lj widths, prenet dropout on, 3 steps at the
constant schedule (lr 1e-3), each against the single-process port step on
the same global batches, whose two shards have very different valid
lengths:

* each step's losses and ``grad_norm`` within 1e-5 relative;
* step 1's gradients (the data axis's sum, a sharded kernel's blocks
  gathered) within 1e-5 of each tensor's largest |g|;
* after the steps, the BatchNorm running statistics within 1e-5 of each
  tensor's largest, and the parameters within 5e-5
  (tests/test_torch_train_parity.py's budget after 3 steps: Adam
  normalizes each element's update, so an element whose gradient is
  rounding noise moves by up to the learning rate either way);
* the parameters also within 1e-5 of each tensor's largest wherever that
  noise cannot reach: the tensors whose step-1 gradient is, in every
  element, at least 1e-2 of the tensor's largest (1000 times the gradient
  tolerance);
* under (1, 2) the ruled kernels are stored sharded, under (2, 1) none.
"""

import numpy as np
import pytest
import torch

from gst_tacotron_tpu.config import save_config
from gst_tacotron_tpu_torch.config import load_config
from gst_tacotron_tpu_torch.parallel.sharding import named_parameters
from gst_tacotron_tpu_torch.train import init_state, make_optimizer, state_dict, train_step

from tests.test_train_smoke import small_cfg
from tests.torch_dist_workers import run_ranks

torch.set_num_threads(2)

STEPS = 3
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
BN_TOL = 1e-5
PARAM_ATOL = 5e-5
PARAM_TOL = 1e-5
NOISE_FLOOR = 1e-2
MESHES = {"dp2": 1, "tp2": 2}


def global_batch(rng, b=4, t_text=12, t_mel=16, num_freq=257):
    """Rows 0-1 (rank 0's) near full length, rows 2-3 (rank 1's) short."""
    tl = np.array([t_text, t_text - 1, 4, 3])[:b]
    ml = np.array([t_mel, t_mel - 2, 6, 4])[:b]
    tmask = np.arange(t_text)[None] < tl[:, None]
    fmask = (np.arange(t_mel)[None] < ml[:, None])[..., None]
    return {"tokens": (rng.integers(1, 40, (b, t_text)) * tmask).astype(np.int64),
            "token_lengths": tl.astype(np.int64),
            "mel": (rng.uniform(0, 1, (b, t_mel, 80)) * fmask).astype(np.float32),
            "mel_lengths": ml.astype(np.int64),
            "linear": (rng.uniform(0, 1, (b, t_mel, num_freq)) * fmask).astype(np.float32),
            "speaker_ids": np.zeros(b, np.int64)}


def port_config(tmp_path_factory, preset="gst_lj", **extra):
    path = str(tmp_path_factory.mktemp("cfg") / "config.json")
    save_config(small_cfg(preset, **{"optimizer.schedule": "constant",
                                      "optimizer.learning_rate": 1e-3, **extra}), path)
    return load_config(path)


def single_process(cfg, batches):
    """The port's single-process steps on the global batches."""
    _, state = init_state(cfg, "cpu")
    tx = make_optimizer(cfg.optimizer)
    metrics, grads = [], None
    for b in batches:
        m = train_step(tx, cfg, state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {k: p.grad.numpy().copy() for k, p in named_parameters(state.model).items()}
    return {"metrics": metrics, "grads": grads,
            "model": {k: v.numpy() for k, v in state_dict(state)["model"].items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = port_config(tmp_path_factory)
    rng = np.random.default_rng(0)
    batches = [global_batch(rng) for _ in range(STEPS)]
    ref = single_process(cfg, batches)
    got = run_ranks("train_steps", 2, cfg, tuple(MESHES.values()), batches)[0]
    return ref, dict(zip(MESHES, got))


def assert_matches(ref, got):
    for step, (r, g) in enumerate(zip(ref["metrics"], got["metrics"])):
        assert r.keys() == g.keys()
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=LOSS_TOL, err_msg=f"step {step} {k}")
    assert ref["grads"].keys() == got["grads"].keys()
    for k, r in ref["grads"].items():
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(got["grads"][k], r, atol=GRAD_TOL * scale, rtol=0, err_msg=k)
    assert ref["model"].keys() == got["model"].keys()
    for k, r in ref["model"].items():
        stat = k.endswith((".mean", ".var"))
        atol = BN_TOL * float(np.abs(r).max()) if stat else PARAM_ATOL
        np.testing.assert_allclose(got["model"][k], r, atol=atol, rtol=0, err_msg=k)
    clean = [k for k, g in ref["grads"].items()
             if np.abs(g).min() >= NOISE_FLOOR * np.abs(g).max() > 0]
    assert len(clean) >= 10, clean
    for k in clean:
        r = ref["model"][k]
        np.testing.assert_allclose(got["model"][k], r, atol=PARAM_TOL * float(np.abs(r).max()),
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_parallel_steps_match_the_single_process_step(runs, mesh):
    ref, got = runs
    assert_matches(ref, got[mesh])


def test_tensor_parallel_stores_the_ruled_kernels_sharded(runs):
    _, got = runs
    assert got["dp2"]["sharded"] == []
    tp = set(got["tp2"]["sharded"])
    assert {"decoder.cell.frame_proj.kernel", "encoder.embedding.embedding",
            "gst.stl.query_proj.kernel", "decoder.cell.decoder_rnn_0.kernel"} <= tp
    assert not any(k.endswith("bias") for k in tp)
