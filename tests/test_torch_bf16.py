"""``model.compute_dtype="bfloat16"`` in the port against the JAX package's
bfloat16 on the CPU (fault C7: the port once ran float32 whatever the field
said, its bf16 mel bit-equal to its float32 mel).

Inputs: ``small_cfg("gst_lj")`` and ``small_cfg("taco1_lj")`` with prenet
dropout 0 (tests/test_torch_train_parity.py), one JAX init carried over by
``weights.load_flat``, that file's first batch. Budgets, each measured on
these inputs (in parentheses) against JAX's own bf16-vs-float32 gap on the
same run (the gap at gst_lj: mel 2.34e-3 max, 4.4e-4 mean):

* the teacher-forced forward at ``train=False``: mean |d| <= 2e-5 and max
  |d| <= 1e-3 for mel, linear, stop logits and alignments (bit-equal: 0);
* each loss term of the training forward (``train=True``): 1e-4 relative
  (<= 8.2e-5; JAX's gap on the total loss 1.8e-4);
* the gradients: L2 norm of the difference over all parameters <= 0.05 of
  the float32 gradient's (0.028 gst_lj, 0.014 taco1_lj; gap 0.116, 0.069),
  each tensor's <= 0.2 of its own (0.133, 0.091; gap up to 0.60), and
  nonzero wherever JAX's is. Bit-equality is out of reach there: XLA sums
  the attention context in another order, and one flipped bf16 rounding
  spreads through the training forward;
* the inference composition (``Synthesizer``: style from the float32 fast
  path, float32 decode, bf16 encoder and post-net) against the JAX
  ``Synthesizer(use_pallas_decoder=True, use_pallas_refenc=True)``, its
  Pallas kernels in interpret mode, no decoder dropout on either side:
  mel, stop logits and alignments 1e-6 (7.5e-8), linear 1e-6 (0). JAX's
  inline Griffin-Lim does not run at bf16 (its loop carry changes dtype),
  so both sides stop at the linear spectrogram here.

And the contract of tests/test_bfloat16.py: the bf16 forward's mean |d|
from float32 < 0.05, a bf16 train step is finite with float32 parameters;
and the port's bf16 output differs from its float32 output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.config import apply_overrides, save_config
from gst_tacotron_tpu.losses import compute_losses as jcompute_losses
from gst_tacotron_tpu.synthesize import Synthesizer as JSynthesizer
from gst_tacotron_tpu.train import _model_kwargs as j_model_kwargs
from gst_tacotron_tpu.train import build_model as jbuild
from gst_tacotron_tpu_torch.config import load_config
from gst_tacotron_tpu_torch.losses import compute_losses
from gst_tacotron_tpu_torch.synthesize import Synthesizer
from gst_tacotron_tpu_torch.train import (TrainState, _model_kwargs, make_optimizer,
                                          train_step)
from gst_tacotron_tpu_torch.weights import build_model, state_key_to_flat

from tests.test_torch_synth_configs import flatten_tree
from tests.test_torch_train_parity import COMMON, make_batch, torch_batch
from tests.test_train_smoke import small_cfg

torch.set_num_threads(2)

OUTPUTS = ("mel", "linear", "stop_logits", "alignments")


def port_config(jcfg, path):
    save_config(jcfg, path)
    return load_config(path)


@pytest.fixture(scope="module", params=["gst_lj", "taco1_lj"])
def run(request, tmp_path_factory):
    name = request.param
    d = tmp_path_factory.mktemp("cfg")
    j32 = small_cfg(name, **COMMON)
    j16 = apply_overrides(j32, {"model.compute_dtype": "bfloat16"})
    c32, c16 = port_config(j32, str(d / "c32.json")), port_config(j16, str(d / "c16.json"))
    batch = make_batch(np.random.default_rng(0), j32.model.num_freq, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    m32, m16 = jbuild(j32), jbuild(j16)
    variables = jax.jit(lambda: m32.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(0)},
        jb["tokens"], jb["token_lengths"], jb["mel"], train=False,
        **j_model_kwargs(j32, jb)))()
    flat = flatten_tree(variables)
    r = j32.model.decoder.reduction_factor

    def jforward(model, cfg):
        return jax.jit(lambda v: model.apply(
            v, jb["tokens"], jb["token_lengths"], jb["mel"], train=False,
            deterministic_prenet=True, rngs={"dropout": jax.random.PRNGKey(1)},
            **j_model_kwargs(cfg, jb)))(variables)

    def jgrad(model, cfg):
        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                 jb["tokens"], jb["token_lengths"], jb["mel"], train=True,
                                 rngs={"dropout": jax.random.PRNGKey(1)},
                                 mutable=["batch_stats"], **j_model_kwargs(cfg, jb))
            losses = jcompute_losses(out, jb, cfg.loss, cfg.audio, reduction_factor=r)
            return losses["loss"], losses
        grads, losses = jax.jit(jax.grad(loss_fn, has_aux=True))(variables["params"])
        return flatten_tree({"params": grads}), {k: float(v) for k, v in losses.items()}

    tb = torch_batch(batch)
    models = {"32": build_model(c32, flat=flat, device="cpu"),
              "16": build_model(c16, flat=flat, device="cpu")}
    tout = {}
    with torch.no_grad():
        for tag, c in (("32", c32), ("16", c16)):
            tout[tag] = models[tag](tb["tokens"], tb["token_lengths"], tb["mel"], train=False,
                                    deterministic_prenet=True, **_model_kwargs(c, tb))
    tmodel = build_model(c16, flat=flat, device="cpu")
    out = tmodel(tb["tokens"], tb["token_lengths"], tb["mel"], train=True,
                 **_model_kwargs(c16, tb))
    tlosses = compute_losses(out, tb, c16.loss, c16.audio, reduction_factor=r)
    tlosses["loss"].backward()
    jg16, jl16 = jgrad(m16, j16)
    jg32, _ = jgrad(m32, j32)
    return dict(name=name, c16=c16, j16=j16, j32=j32, flat=flat, variables=variables,
                batch=batch, jout={"32": jforward(m32, j32), "16": jforward(m16, j16)},
                tout=tout, tlosses={k: float(v.detach()) for k, v in tlosses.items()},
                jlosses=jl16, jg16=jg16, jg32=jg32,
                tgrads={state_key_to_flat(k): p.grad.numpy() for k, p in
                        tmodel.named_parameters()})


def f32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def test_forward_matches_jax_bf16(run):
    for key in OUTPUTS:
        got, ref = f32(run["tout"]["16"][key]), f32(run["jout"]["16"][key])
        assert run["tout"]["16"][key].dtype == torch.bfloat16, key
        assert got.shape == ref.shape, key
        d = np.abs(got - ref)
        assert d.mean() <= 2e-5 and d.max() <= 1e-3, (key, d.mean(), d.max())


def test_bf16_differs_from_f32_within_the_jax_contract(run):
    for key in OUTPUTS:
        b16, b32 = f32(run["tout"]["16"][key]), f32(run["tout"]["32"][key])
        assert np.all(np.isfinite(b16)), key
        assert np.abs(b16 - b32).max() > 0, f"{key}: bf16 output equals the float32 one"
    assert np.mean(np.abs(f32(run["tout"]["16"]["mel"]) - f32(run["tout"]["32"]["mel"]))) < 0.05


def test_loss_terms_match_jax_bf16(run):
    assert run["tlosses"].keys() == run["jlosses"].keys()
    for key, ref in run["jlosses"].items():
        np.testing.assert_allclose(run["tlosses"][key], ref, rtol=1e-4, err_msg=key)


def test_gradients_match_jax_bf16(run):
    jg, tg, g32 = run["jg16"], run["tgrads"], run["jg32"]
    assert jg.keys() == tg.keys()
    num = sum(float(((tg[k] - jg[k]) ** 2).sum()) for k in jg)
    den = sum(float((g32[k] ** 2).sum()) for k in jg)
    assert np.sqrt(num / den) <= 0.05, np.sqrt(num / den)
    for key, ref in jg.items():
        scale = float(np.linalg.norm(g32[key]))
        if np.abs(ref).max() > 0:
            assert np.abs(tg[key]).max() > 0, f"{key}: no gradient"
        assert np.linalg.norm(tg[key] - ref) <= 0.2 * scale, key


def test_bf16_train_step_keeps_float32_parameters(run):
    c16 = run["c16"]
    model = build_model(c16, flat=run["flat"], device="cpu")
    tx = make_optimizer(c16.optimizer)
    state = TrainState(0, model, tx.init(dict(model.named_parameters())), 0)
    metrics = train_step(tx, c16, state, torch_batch(run["batch"]))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers() if b.is_floating_point())


class _NoVocoder:
    """Stops the JAX Synthesizer at the linear spectrogram: its inline
    Griffin-Lim does not trace on a bf16 spectrogram."""
    kind = "none"

    def __call__(self, outputs, key):
        return jnp.zeros((outputs["mel"].shape[0], 1))


def test_inference_composition_matches_jax_kernel_path(run, tmp_path):
    short = {"model.decoder.max_decode_steps": 6, "audio.griffin_lim_iters": 2}
    j16 = apply_overrides(run["j16"], short)
    c16 = port_config(j16, str(tmp_path / "c16.json"))
    texts = ["hello world.", "testing the fast path."]
    kw = {}
    if j16.model.gst.enabled:
        wav = (0.1 * np.random.default_rng(0).standard_normal(
            j16.audio.sample_rate // 4)).astype(np.float32)
        kw = {"reference_wavs": [wav, wav]}
    jsyn = JSynthesizer(j16, jbuild(j16), run["variables"], use_pallas_decoder=True,
                        use_pallas_refenc=j16.model.gst.enabled, vocoder=_NoVocoder())
    ref = jsyn(texts, seed=0, **kw)
    got = Synthesizer(c16, build_model(c16, flat=run["flat"], device="cpu"), device="cpu",
                      deterministic_prenet=True)(texts, seed=0, **kw)
    for key in OUTPUTS:
        np.testing.assert_allclose(got[key], np.asarray(ref[key], np.float32), atol=1e-6,
                                   rtol=0, err_msg=key)
    assert np.all(np.isfinite(got["wav"]))
