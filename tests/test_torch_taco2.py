"""The Taco2 encoder (``model.encoder.kind = "taco2"``: embedding, three
5-tap conv + BatchNorm + ReLU layers, a BiGRU) against the JAX package on
the CPU, at the small widths of tests/test_train_smoke.py::small_cfg:

* ``Conv1dBNStack`` at eval (running statistics made non-trivial) and in
  train mode (the batch's statistics): output 1e-5, updated statistics
  1e-6, with dropout 0 on both sides (jax.random's masks cannot be
  reproduced); with dropout 0.5 the stack is the identity of dropout at
  eval, and in training a seeded inverted-dropout mask;
* ``Taco2Encoder`` 1e-5;
* the whole taco2 ``GSTTacotron``: the teacher-forced forward (1e-5), the
  batch statistics (1e-6), each loss term (1e-5 relative) and the
  gradients (1e-4 of each tensor's largest, nonzero wherever JAX's is),
  tests/test_torch_train_parity.py's budgets, the JAX stack's dropout set
  to 0 as the port's;
* the ``Synthesizer`` at ``deterministic_prenet=True``: the golden gate's
  budgets (mel MAE < 1e-4, allclose 1e-3, MCD < 0.1 dB, equal frame
  lengths; tests/test_torch_synth.py);
* ``model.compute_dtype="bfloat16"``: tests/test_torch_bf16.py's budgets for
  the forward (mean |d| <= 2e-5, max <= 1e-3) and the loss terms (1e-4
  relative) against JAX's bf16;
* the chunked decoder at stop threshold 1.0 and a one-rank
  ``DistributedSynthesizer`` give the fixed-length ``Synthesizer``'s bits;
* a data-parallel step of two gloo ranks against the single-process step,
  the stack's dropout on (tests/test_torch_parallel_train.py's budgets);
* the sharding rules rule the same keys as JAX's at a taco2 config.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gst_tacotron_tpu.config import apply_overrides as japply
from gst_tacotron_tpu.config import save_config
from gst_tacotron_tpu.losses import compute_losses as jcompute_losses
from gst_tacotron_tpu.models import encoder as jencoder
from gst_tacotron_tpu.models.encoder import Taco2Encoder as JTaco2Encoder
from gst_tacotron_tpu.models.modules import Conv1dBNStack as JConv1dBNStack
from gst_tacotron_tpu.parallel.sharding import spec_for_path as jspec_for_path
from gst_tacotron_tpu.synthesize import Synthesizer as JSynthesizer
from gst_tacotron_tpu.train import _model_kwargs as j_model_kwargs
from gst_tacotron_tpu.train import build_model as jbuild
from gst_tacotron_tpu_torch.config import load_config
from gst_tacotron_tpu_torch.losses import compute_losses
from gst_tacotron_tpu_torch.models import Conv1dBNStack, GSTTacotron, Taco2Encoder
from gst_tacotron_tpu_torch.parallel import MODEL_AXIS, describe_sharding
from gst_tacotron_tpu_torch.synthesize import Synthesizer
from gst_tacotron_tpu_torch.train import _model_kwargs
from gst_tacotron_tpu_torch.weights import build_model, export_flat, load_flat

from tests.test_torch_parallel_mesh import _jax_flat_paths
from tests.test_torch_parallel_train import assert_matches, global_batch, single_process
from tests.test_torch_synth import assert_slice_close
from tests.test_torch_synth_configs import flatten_tree
from tests.test_torch_train_parity import COMMON, make_batch, torch_batch, torch_grads
from tests.test_train_smoke import small_cfg
from tests.torch_dist_workers import run_ranks

torch.set_num_threads(2)

TACO2 = {"model.encoder.kind": "taco2"}
B, T, C = 3, 11, 16
LENGTHS = np.array([11, 7, 4])


def port_config(jcfg, path):
    save_config(jcfg, path)
    return load_config(str(path))


def no_stack_dropout(monkeypatch):
    """The JAX Taco2 encoder with its stack's dropout at 0 (it is a fixed
    0.5 there; the port's is the module's ``dropout_rate``)."""
    monkeypatch.setattr(jencoder, "Conv1dBNStack",
                        functools.partial(JConv1dBNStack, dropout_rate=0.0))


def stack_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (B, T, C)).astype(np.float32)
    return x, rng


def jax_stack(rng, dropout_rate=0.0):
    x = jnp.zeros((B, T, C))
    jm = JConv1dBNStack([C, 12, C], kernel_size=5, dropout_rate=dropout_rate)
    variables = jm.init(jax.random.PRNGKey(0), x, jnp.asarray(LENGTHS))
    stats = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.uniform(0.5, 1.5, s.shape), jnp.float32),
        variables["batch_stats"])
    return jm, {"params": variables["params"], "batch_stats": stats}


def port_stack(variables, dropout_rate=0.0):
    m = Conv1dBNStack(C, [C, 12, C], kernel_size=5, dropout_rate=dropout_rate)
    load_flat(m, flatten_tree(variables))
    return m


def test_conv_stack_matches_jax_at_eval_and_in_training():
    x, rng = stack_inputs()
    jm, variables = jax_stack(rng)
    m = port_stack(variables)
    tx, tl = torch.from_numpy(x), torch.from_numpy(LENGTHS)
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(LENGTHS))
    got = m(tx, tl).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    ref, mut = jm.apply(variables, jnp.asarray(x), jnp.asarray(LENGTHS), train=True,
                        mutable=["batch_stats"])
    got = m(tx, tl, train=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    jstats = flatten_tree({"batch_stats": mut["batch_stats"]})
    tstats = {k: v for k, v in export_flat(m).items() if k.startswith("batch_stats/")}
    assert jstats.keys() == tstats.keys() and len(jstats) == 6
    for k, r in jstats.items():
        np.testing.assert_allclose(tstats[k], r, atol=1e-6, rtol=0, err_msg=k)


def test_conv_stack_dropout_is_off_at_eval_and_seeded_in_training():
    x, rng = stack_inputs()
    _, variables = jax_stack(rng)
    m, m0 = port_stack(variables, 0.5), port_stack(variables, 0.0)
    tx, tl = torch.from_numpy(x), torch.from_numpy(LENGTHS)
    with torch.no_grad():
        assert torch.equal(m(tx, tl), m0(tx, tl))      # eval: no dropout
    # one layer in training: inverted dropout of the dropout-0 output, the
    # mask a function of the generator's seed
    one, one0 = (Conv1dBNStack(C, [C], kernel_size=5, dropout_rate=r) for r in (0.5, 0.0))
    with torch.no_grad():
        for p in one.parameters():
            p.normal_(0, 0.3, generator=torch.Generator().manual_seed(1))
        one0.load_state_dict(one.state_dict())
        y0 = one0(tx, tl, train=True)
        a, b, c = (one(tx, tl, train=True, generator=torch.Generator().manual_seed(s))
                   for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    torch.testing.assert_close(a[kept], 2 * y0[kept], rtol=0, atol=0)
    dropped = float((~kept & (y0 != 0)).sum() / (y0 != 0).sum())
    assert 0.4 < dropped < 0.6, dropped


def test_taco2_encoder_matches_jax():
    jcfg = small_cfg("gst_lj", **TACO2)
    rng = np.random.default_rng(1)
    tokens = (rng.integers(1, 40, (B, T)) * (np.arange(T)[None] < LENGTHS[:, None]))
    jm = JTaco2Encoder(jcfg.model.encoder, 40)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(tokens), jnp.asarray(LENGTHS))
    ref = jm.apply(variables, jnp.asarray(tokens), jnp.asarray(LENGTHS))
    m = Taco2Encoder(load_config_from(jcfg).model.encoder, 40)
    load_flat(m, flatten_tree(variables))
    got = m(torch.from_numpy(tokens), torch.from_numpy(LENGTHS)).detach().numpy()
    assert got.shape == (B, T, 2 * jcfg.model.encoder.cbhg_gru_dim)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)


def load_config_from(jcfg):
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        return port_config(jcfg, f"{d}/config.json")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The taco2 model's forward, batch statistics, losses and gradients on
    both sides from one JAX init, the JAX stack's dropout at 0."""
    jcfg = small_cfg("gst_lj", **TACO2, **COMMON)
    cfg = port_config(jcfg, tmp_path_factory.mktemp("cfg") / "config.json")
    batch = make_batch(np.random.default_rng(0), jcfg.model.num_freq, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    r = jcfg.model.decoder.reduction_factor
    with pytest.MonkeyPatch.context() as mp:
        no_stack_dropout(mp)
        model = jbuild(jcfg)
        variables = jax.jit(lambda: model.init(
            {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(0)},
            jb["tokens"], jb["token_lengths"], jb["mel"], train=False,
            **j_model_kwargs(jcfg, jb)))()

        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                   jb["tokens"], jb["token_lengths"], jb["mel"], train=True,
                                   rngs={"dropout": jax.random.PRNGKey(1)},
                                   mutable=["batch_stats"], **j_model_kwargs(jcfg, jb))
            losses = jcompute_losses(out, jb, jcfg.loss, jcfg.audio, reduction_factor=r)
            return losses["loss"], (out, losses, mut["batch_stats"])
        jgrads, (jout, jlosses, jstats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            variables["params"])
    flat = flatten_tree(variables)
    tmodel = build_model(cfg, flat=flat, device="cpu")
    tmodel.encoder.convs.dropout_rate = 0.0
    tb = torch_batch(batch)
    tout = tmodel(tb["tokens"], tb["token_lengths"], tb["mel"], train=True,
                  **_model_kwargs(cfg, tb))
    tlosses = compute_losses(tout, tb, cfg.loss, cfg.audio, reduction_factor=r)
    tlosses["loss"].backward()
    return dict(jcfg=jcfg, cfg=cfg, flat=flat, variables=variables, batch=batch, jout=jout,
                jlosses=jlosses, jstats=flatten_tree({"batch_stats": jstats}),
                jgrads=flatten_tree({"params": jgrads}), tout=tout, tlosses=tlosses,
                tstats=export_flat(tmodel), tgrads=torch_grads(tmodel))


def test_taco2_model_forward_and_batch_stats(run):
    assert any("encoder/convs/bn_2" in k for k in run["jstats"])
    for key in ("mel", "linear", "stop_logits", "alignments"):
        got, ref = run["tout"][key].detach().numpy(), np.asarray(run["jout"][key])
        assert got.shape == ref.shape, key
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=key)
    for key, ref in run["jstats"].items():
        np.testing.assert_allclose(run["tstats"][key], ref, atol=1e-6, rtol=0, err_msg=key)


def test_taco2_model_losses_and_gradients(run):
    assert set(run["tlosses"]) == set(run["jlosses"])
    for key, ref in run["jlosses"].items():
        np.testing.assert_allclose(float(run["tlosses"][key].detach()), float(ref), rtol=1e-5,
                                   err_msg=key)
    jg, tg = run["jgrads"], run["tgrads"]
    assert jg.keys() == tg.keys()
    assert "params/encoder/convs/conv_0/kernel" in jg
    for key, ref in jg.items():
        scale = float(np.abs(ref).max())
        if scale > 0:
            assert np.abs(tg[key]).max() > 0, f"{key}: no gradient, JAX's reaches {scale}"
        np.testing.assert_allclose(tg[key], ref, atol=1e-4 * scale, rtol=0, err_msg=key)


def test_taco2_synthesizer_matches_jax(run, tmp_path):
    jcfg = japply(run["jcfg"], {"audio.griffin_lim_bf16": False,
                                "model.decoder.stop_threshold": 1.5,
                                "model.decoder.max_decode_steps": 6})
    cfg = port_config(jcfg, tmp_path / "config.json")
    texts = ["the taco two encoder.", "a second sentence."]
    wav = (0.3 * np.sin(2 * np.pi * 150 * np.arange(5000) / jcfg.audio.sample_rate)
           ).astype(np.float32)
    ref = JSynthesizer(jcfg, jbuild(jcfg), run["variables"], deterministic_prenet=True)(
        texts, reference_wavs=[wav, wav], seed=0)
    got = Synthesizer(cfg, build_model(cfg, flat=run["flat"], device="cpu"), device="cpu",
                      deterministic_prenet=True)(texts, reference_wavs=[wav, wav], seed=0)
    assert got["mel"].shape == ref["mel"].shape == (2, 12, 80)
    assert_slice_close(got, ref)


def test_taco2_bf16_matches_jax_bf16(run, tmp_path):
    j16 = japply(run["jcfg"], {"model.compute_dtype": "bfloat16"})
    c16 = port_config(j16, tmp_path / "config.json")
    jb = {k: jnp.asarray(v) for k, v in run["batch"].items()}
    r = j16.model.decoder.reduction_factor
    with pytest.MonkeyPatch.context() as mp:
        no_stack_dropout(mp)
        m16 = jbuild(j16)

        def fwd(v, train):
            out = m16.apply(v, jb["tokens"], jb["token_lengths"], jb["mel"], train=train,
                            deterministic_prenet=True, rngs={"dropout": jax.random.PRNGKey(1)},
                            mutable=["batch_stats"] if train else False,
                            **j_model_kwargs(j16, jb))
            out = out[0] if train else out
            return out, jcompute_losses(out, jb, j16.loss, j16.audio, reduction_factor=r)
        jout, _ = jax.jit(lambda v: fwd(v, False))(run["variables"])
        _, jlosses = jax.jit(lambda v: fwd(v, True))(run["variables"])
    model = build_model(c16, flat=run["flat"], device="cpu")
    model.encoder.convs.dropout_rate = 0.0
    tb = torch_batch(run["batch"])
    with torch.no_grad():
        tout = model(tb["tokens"], tb["token_lengths"], tb["mel"], train=False,
                     deterministic_prenet=True, **_model_kwargs(c16, tb))
        tr = model(tb["tokens"], tb["token_lengths"], tb["mel"], train=True,
                   **_model_kwargs(c16, tb))
        tlosses = compute_losses(tr, tb, c16.loss, c16.audio, reduction_factor=r)
    for key in ("mel", "linear", "stop_logits", "alignments"):
        assert tout[key].dtype == torch.bfloat16, key
        d = np.abs(tout[key].float().numpy() - np.asarray(jout[key], np.float32))
        assert d.mean() <= 2e-5 and d.max() <= 1e-3, (key, d.mean(), d.max())
    for key, ref in jlosses.items():
        np.testing.assert_allclose(float(tlosses[key]), float(ref), rtol=1e-4, err_msg=key)


def test_taco2_chunked_and_distributed_synthesis_give_the_fixed_bits(run):
    from gst_tacotron_tpu_torch.config import apply_overrides
    from gst_tacotron_tpu_torch.parallel import DistributedSynthesizer, make_mesh

    cfg = apply_overrides(run["cfg"], {"model.decoder.stop_threshold": 1.0,
                                       "model.decoder.max_decode_steps": 6})
    model = build_model(cfg, flat=run["flat"], device="cpu")
    texts = ["the taco two encoder.", "chunks."]
    w = np.eye(cfg.model.gst.num_tokens, dtype=np.float32)[[1, 4]]
    fixed = Synthesizer(cfg, model, device="cpu")(texts, token_weights=w, seed=3)
    chunked = Synthesizer(cfg, model, device="cpu", use_chunked_decoder=True, chunk_steps=3)(
        texts, token_weights=w, seed=3)
    dist = DistributedSynthesizer(cfg, model, make_mesh(1), device="cpu").synthesize(
        texts, token_weights=w, seed=3)
    assert chunked["chunks_run"] == 2
    for out in (chunked, dist):
        for key in ("mel", "linear", "alignments", "wav"):
            np.testing.assert_array_equal(out[key], fixed[key], err_msg=key)


def test_taco2_data_parallel_step_matches_the_single_process_step(tmp_path):
    jcfg = small_cfg("gst_lj", **TACO2, **{"optimizer.schedule": "constant",
                                          "optimizer.learning_rate": 1e-3})
    cfg = port_config(jcfg, tmp_path / "config.json")
    assert cfg.model.encoder.kind == "taco2"
    rng = np.random.default_rng(0)
    batches = [global_batch(rng)]
    ref = single_process(cfg, batches)
    got = run_ranks("train_steps", 2, cfg, (1,), batches)[0][0]
    assert_matches(ref, got)


def test_taco2_ruled_sharding_keys_equal_the_jax_rules():
    jcfg = small_cfg("gst_lj", **TACO2)
    model = jbuild(jcfg)
    tokens, mel = jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 16, 80), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        tokens, jnp.array([8]), mel, train=False, ref_mel=mel))
    jtree = _jax_flat_paths(shapes["params"])
    cfg = load_config_from(jcfg)
    with torch.device("meta"):
        tmodel = GSTTacotron(cfg.model, 40)
    desc = describe_sharding(dict(tmodel.named_parameters()))
    assert set(desc) == set(jtree)
    assert "encoder/convs/conv_0/kernel" in desc and "encoder/bigru/forward/kernel" in desc
    jruled = {p for p, nd in jtree.items() if jspec_for_path(p, nd) != P()}
    assert "encoder/embedding/embedding" in jruled
    assert {p for p, spec in desc.items() if MODEL_AXIS in spec} == jruled
