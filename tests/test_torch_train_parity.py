"""The port's training path against the JAX package on the CPU, at the small
widths of tests/test_train_smoke.py::small_cfg, for gst_lj (Bahdanau, r=2),
gst_r1_location (location-sensitive, r=1) and gst_multispeaker (speaker
embedding), with prenet dropout 0 on both sides (jax.random's masks cannot
be reproduced) and the JAX init carried over by ``weights.load_flat``:

* the teacher-forced forward (``model.apply(train=True,
  mutable=["batch_stats"])``) within 1e-5, the updated batch statistics
  within 1e-6, each loss term within 1e-5 relative;
* every parameter's gradient within 1e-4 of that tensor's largest |g| under
  ``jax.grad``, and nonzero wherever JAX's is;
* three ``train_step``s at the constant schedule (lr 1e-3) against the JAX
  ``train_step``'s body (``jax.grad``, the optax chain of ``make_optimizer``,
  ``optax.global_norm``): losses and ``grad_norm`` within 1e-4 relative,
  then parameters, both Adam moments and the running statistics within 5e-5;
* ``make_schedule``, all three kinds, within 1e-7 relative;
* one attention step of each kind (the modules' ``__call__``) within 1e-6;
* the WaveRNN loss and its gradients against ``WaveRNN.loss`` under
  ``jax.grad``: the teacher-forced pass once gave no WaveRNN parameter a
  gradient (its pack was detached).

gst_multispeaker's ``Synthesizer`` is held against the JAX one in
tests/test_torch_multispeaker.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gst_tacotron_tpu.config import AttentionConfig as JAttentionConfig
from gst_tacotron_tpu.config import OptimizerConfig as JOptimizerConfig
from gst_tacotron_tpu.config import save_config
from gst_tacotron_tpu.dsp.jax_dsp import mulaw_encode
from gst_tacotron_tpu.losses import compute_losses as jcompute_losses
from gst_tacotron_tpu.models.attention import make_attention as jmake_attention
from gst_tacotron_tpu.models.wavernn import WaveRNN as JWaveRNN
from gst_tacotron_tpu.train import _model_kwargs as j_model_kwargs
from gst_tacotron_tpu.train import build_model as jbuild
from gst_tacotron_tpu.train import make_optimizer as jmake_optimizer
from gst_tacotron_tpu.train import make_schedule as jmake_schedule
from gst_tacotron_tpu_torch.config import AttentionConfig, OptimizerConfig, load_config
from gst_tacotron_tpu_torch.losses import compute_losses
from gst_tacotron_tpu_torch.models.attention import make_attention
from gst_tacotron_tpu_torch.train import (TrainState, _model_kwargs, make_optimizer,
                                          make_schedule, train_step)
from gst_tacotron_tpu_torch.weights import (build_model, build_wavernn, export_flat,
                                            load_flat, state_key_to_flat)

from tests.test_torch_synth_configs import flatten_tree
from tests.test_train_smoke import small_cfg

torch.set_num_threads(2)

CONFIGS = {
    "gst_lj": {},
    "gst_r1_location": {"model.attention.location_filters": 4,
                        "model.attention.location_kernel_size": 7},
    "gst_multispeaker": {"model.num_speakers": 3, "model.speaker_dim": 8},
}
COMMON = {"model.encoder.prenet_dropout": 0.0, "model.decoder.prenet_dropout": 0.0,
          "optimizer.schedule": "constant", "optimizer.learning_rate": 1e-3}
B, T_TEXT, T_MEL = 2, 12, 16
STEPS = 3


def make_batch(rng, num_freq, num_speakers):
    """Random tokens with no symbol twice in a row: two equal neighbours give
    the encoder's maxpool equal inputs (the width-1 bank sees the same
    prenet row), and which side takes the gradient then rests on a one-ulp
    rounding difference in XLA's product, not on the model."""
    tl, ml = np.array([T_TEXT, 7]), np.array([T_MEL, 10])
    tmask = np.arange(T_TEXT)[None] < tl[:, None]
    fmask = (np.arange(T_MEL)[None] < ml[:, None])[..., None]
    steps = rng.integers(1, 39, (B, T_TEXT))
    tokens = 1 + (rng.integers(0, 39, (B, 1)) + np.cumsum(steps, 1)) % 39
    return {"tokens": (tokens * tmask).astype(np.int32),
            "token_lengths": tl.astype(np.int32),
            "mel": (rng.uniform(0, 1, (B, T_MEL, 80)) * fmask).astype(np.float32),
            "mel_lengths": ml.astype(np.int32),
            "linear": (rng.uniform(0, 1, (B, T_MEL, num_freq)) * fmask).astype(np.float32),
            "speaker_ids": rng.integers(0, num_speakers, B).astype(np.int32)}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def torch_grads(model):
    return {state_key_to_flat(k): p.grad.numpy().copy() for k, p in model.named_parameters()}


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request, tmp_path_factory):
    """Both packages' forward, losses and gradients on one batch, and three
    train steps on three batches, from the same weights."""
    name = request.param
    jcfg = small_cfg(name, **CONFIGS[name], **COMMON)
    path = str(tmp_path_factory.mktemp("cfg") / "config.json")
    save_config(jcfg, path)
    cfg = load_config(path)
    rng = np.random.default_rng(0)
    batches = [make_batch(rng, jcfg.model.num_freq, jcfg.model.num_speakers)
               for _ in range(STEPS)]
    model = jbuild(jcfg)
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    variables = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(0)},
        b0["tokens"], b0["token_lengths"], b0["mel"], train=False,
        **j_model_kwargs(jcfg, b0)))()
    params, stats = variables["params"], variables["batch_stats"]
    flat = flatten_tree({"params": params, "batch_stats": stats})
    r = jcfg.model.decoder.reduction_factor

    @jax.jit
    def forward_grad(params, stats, batch):
        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, batch["tokens"],
                                   batch["token_lengths"], batch["mel"], train=True,
                                   rngs={"dropout": jax.random.PRNGKey(1)},
                                   mutable=["batch_stats"], **j_model_kwargs(jcfg, batch))
            losses = jcompute_losses(out, batch, jcfg.loss, jcfg.audio, reduction_factor=r)
            return losses["loss"], (out, losses, mut["batch_stats"])
        return jax.grad(loss_fn, has_aux=True)(params)

    jgrads, (jout, jlosses, jstats) = forward_grad(params, stats, b0)
    # three steps of the JAX train_step's body (grad, then the optax chain),
    # reusing the compiled gradient
    tx = jmake_optimizer(jcfg.optimizer)

    @jax.jit
    def update(grads, opt, p):
        updates, opt = tx.update(grads, opt, p)
        return optax.apply_updates(p, updates), opt, optax.global_norm(grads)

    jp, js, jopt = params, stats, tx.init(params)
    jmetrics = []
    for b in batches:
        grads, (_, losses, js) = forward_grad(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        jp, jopt, norm = update(grads, jopt, jp)
        jmetrics.append({**{k: float(v) for k, v in losses.items()}, "grad_norm": float(norm)})

    tmodel = build_model(cfg, flat=flat, device="cpu")
    tb = torch_batch(batches[0])
    tout = tmodel(tb["tokens"], tb["token_lengths"], tb["mel"], train=True,
                  **_model_kwargs(cfg, tb))
    tlosses = compute_losses(tout, tb, cfg.loss, cfg.audio, reduction_factor=r)
    tlosses["loss"].backward()
    tstats = export_flat(tmodel)

    smodel = build_model(cfg, flat=flat, device="cpu")
    otx = make_optimizer(cfg.optimizer)
    state = TrainState(0, smodel, otx.init(dict(smodel.named_parameters())), 0)
    tmetrics = [{k: float(v) for k, v in train_step(otx, cfg, state, torch_batch(b)).items()}
                for b in batches]
    adam = jopt[1]
    return dict(
        name=name, jout=jout, jlosses=jlosses, jstats=flatten_tree({"batch_stats": jstats}),
        jgrads=flatten_tree({"params": jgrads}), tout=tout, tlosses=tlosses, tstats=tstats,
        tgrads=torch_grads(tmodel), jmetrics=jmetrics, tmetrics=tmetrics,
        jafter=flatten_tree({"params": jp, "batch_stats": js}),
        jmu=flatten_tree({"params": adam.mu}), jnu=flatten_tree({"params": adam.nu}),
        tafter=export_flat(smodel), state=state, jcount=int(adam.count))


def test_teacher_forced_forward_and_batch_stats(run):
    for key in ("mel", "linear", "stop_logits", "alignments"):
        got, ref = run["tout"][key].detach().numpy(), np.asarray(run["jout"][key])
        assert got.shape == ref.shape, key
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=key)
    assert run["jstats"].keys() <= run["tstats"].keys()
    for key, ref in run["jstats"].items():
        np.testing.assert_allclose(run["tstats"][key], ref, atol=1e-6, rtol=0, err_msg=key)


def test_loss_terms(run):
    assert set(run["tlosses"]) == set(run["jlosses"])
    if run["name"] != "gst_multispeaker":
        assert "guided_loss" in run["tlosses"]        # the presets' guided attention
    for key, ref in run["jlosses"].items():
        np.testing.assert_allclose(float(run["tlosses"][key].detach()), float(ref), rtol=1e-5,
                                   err_msg=key)


def test_gradients(run):
    jg, tg = run["jgrads"], run["tgrads"]
    assert jg.keys() == tg.keys()
    for key, ref in jg.items():
        scale = float(np.abs(ref).max())
        if scale > 0:
            assert np.abs(tg[key]).max() > 0, f"{key}: no gradient, JAX's reaches {scale}"
        np.testing.assert_allclose(tg[key], ref, atol=1e-4 * scale, rtol=0, err_msg=key)


def test_three_train_steps(run):
    for step, (t, j) in enumerate(zip(run["tmetrics"], run["jmetrics"])):
        assert t.keys() == j.keys()
        for key in j:
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                       err_msg=f"step {step} {key}")
    state = run["state"]
    assert state.step == STEPS and state.opt.count == run["jcount"] == STEPS
    assert run["jafter"].keys() == run["tafter"].keys()
    for key, ref in run["jafter"].items():
        np.testing.assert_allclose(run["tafter"][key], ref, atol=5e-5, rtol=0, err_msg=key)
    for name in ("mu", "nu"):
        mine = {state_key_to_flat(k): v.numpy() for k, v in getattr(state.opt, name).items()}
        ref = run[f"j{name}"]
        assert mine.keys() == ref.keys()
        for key in ref:
            np.testing.assert_allclose(mine[key], ref[key], atol=5e-5, rtol=0,
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("kind", ["noam", "exponential", "constant"])
def test_schedules(kind):
    ref = jmake_schedule(JOptimizerConfig(schedule=kind))
    got = make_schedule(OptimizerConfig(schedule=kind))
    for count in (0, 1, 10, 4000, 100000):
        want = float(ref(jnp.asarray(count, jnp.int32)))
        np.testing.assert_allclose(float(got(count)), want, rtol=1e-7, err_msg=str(count))


@pytest.mark.parametrize("kind", ["bahdanau", "location_sensitive"])
def test_attention_step_matches_jax(kind):
    """One step of the attention module from a non-trivial state, a row
    masked past position 4."""
    fields = dict(kind=kind, dim=8, location_filters=4, location_kernel_size=5)
    jatt = jmake_attention(JAttentionConfig(**fields))
    rng = np.random.default_rng(3)
    query = rng.normal(0, 1, (2, 6)).astype(np.float32)
    memory = rng.normal(0, 1, (2, 7, 10)).astype(np.float32)
    mask = np.arange(7)[None] < np.array([7, 4])[:, None]
    prev = rng.dirichlet(np.ones(7), 2).astype(np.float32)
    state = {"alignment": prev, "cumulative": (prev + rng.uniform(0, 2, (2, 7))
                                               ).astype(np.float32)}

    def step(m, q, mem, mk, st):
        return m(q, mem, m.precompute(mem), mk, st)

    variables = jatt.init(jax.random.PRNGKey(0), query, memory, mask, state, method=step)
    ctx, align, new = jatt.apply(variables, query, memory, mask, state, method=step)
    att = make_attention(AttentionConfig(**fields), 6, 10)
    load_flat(att, flatten_tree({"params": variables["params"]}))
    t = torch.from_numpy
    got = att(t(query), t(memory), att.precompute(t(memory)), t(mask),
              {k: t(v) for k, v in state.items()})
    pairs = [(got[0], ctx), (got[1], align)] + [(got[2][k], new[k]) for k in new]
    for mine, ref in pairs:
        np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref), atol=1e-6)


def test_wavernn_loss_and_gradients():
    """The teacher-forced WaveRNN pass trains every parameter, as jax.grad
    of ``WaveRNN.loss`` does."""
    cfg = load_config_from_jax(small_cfg("gst_wavernn", **{
        "model.vocoder.wavernn_gru_dim": 32, "model.vocoder.wavernn_fc_dim": 32,
        "model.vocoder.wavernn_bits": 8, "model.vocoder.wavernn_hop": 16}))
    jvoc = JWaveRNN(cfg.model.vocoder, 80)
    rng = np.random.default_rng(5)
    mel = rng.uniform(0, 1, (2, 6, 80)).astype(np.float32)
    wav = np.clip(rng.normal(0, 0.3, (2, 96)), -1, 1).astype(np.float32)
    variables = jvoc.init(jax.random.PRNGKey(7), jnp.asarray(mel), jnp.asarray(wav))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jvoc.apply(
        {"params": p}, jnp.asarray(mel), jnp.asarray(wav), method=jvoc.loss)))(
        variables["params"])
    model = build_wavernn(cfg, flat=flatten_tree({"params": variables["params"]}),
                          device="cpu")
    tmel, twav = torch.from_numpy(mel), torch.from_numpy(wav)
    # the loss from the teacher-forced logits, as JAX's WaveRNN.loss takes it
    logp = torch.log_softmax(model(tmel, twav), -1)
    classes = torch.from_numpy(np.array(mulaw_encode(jnp.asarray(wav), 8))).long()
    got = -logp.gather(-1, classes[..., None]).mean()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(model.loss(tmel, twav).detach()), float(loss), rtol=1e-5)
    jg = flatten_tree({"params": grads})
    tg = {state_key_to_flat(k): None if p.grad is None else p.grad.numpy()
          for k, p in model.named_parameters()}
    assert jg.keys() == tg.keys()
    for key, ref in jg.items():
        scale = float(np.abs(ref).max())
        assert scale > 0, key
        assert tg[key] is not None and np.abs(tg[key]).max() > 0, \
            f"{key}: no gradient, JAX's reaches {scale}"
        np.testing.assert_allclose(tg[key], ref, atol=1e-4 * scale, rtol=0, err_msg=key)


def load_config_from_jax(jcfg):
    """The port's copy of a JAX config (the same dict through JSON)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        save_config(jcfg, f"{d}/config.json")
        return load_config(f"{d}/config.json")
