"""K2's and K3's bf16 operand modes (fault C8): the port's plain versions
against the JAX kernels' bf16 modes in interpret mode, on the same weights and
numpy inputs, and the rule by which ``bf16=None`` resolves.

Both sides round the same operands to bfloat16 and sum their products (exact
in float32) in float32, so they agree far inside JAX's own bf16 budget (0.05
of float32, ``tests/test_refenc_pallas.py``). They part only where two
float32 sum orders put a value on either side of a bf16 rounding boundary,
which moves it one bf16 step (2^-8 relative): rarely, so each tolerance
holds a maximum and a mean, and each test checks that the mean is far below
the bf16 function's distance from the float32 one."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.config import AudioConfig as JAudioConfig
from gst_tacotron_tpu.config import GSTConfig as JGSTConfig
from gst_tacotron_tpu.dsp import ref as jref
from gst_tacotron_tpu.models.gst import ReferenceEncoder as JRefEnc
from gst_tacotron_tpu.ops import refenc_pallas as jrefenc
from gst_tacotron_tpu.ops.stft_pallas import stft_features_pallas_resident
from gst_tacotron_tpu_torch.config import AudioConfig, GSTConfig
from gst_tacotron_tpu_torch.dsp.device_features import DeviceFeatureExtractor
from gst_tacotron_tpu_torch.models.gst import ReferenceEncoder
from gst_tacotron_tpu_torch.ops import refenc as trefenc
from gst_tacotron_tpu_torch.ops import stft as tstft
from gst_tacotron_tpu_torch.weights import load_flat

torch.set_num_threads(2)

NUM_MELS = 80
# the flagship stack's channels at a cut GRU width
GST_KW = dict(ref_conv_channels=(32, 32, 64, 64, 128, 128), ref_gru_dim=16, style_dim=16,
              num_tokens=5, num_heads=2)
# the bf16 stack against JAX's: max and mean abs (at the float32 stack's
# magnitude ~1; measured 1.5e-4 and 5.2e-6, the bf16 - float32 gap 1.2e-3
# and 1.6e-4)
STACK_TOL, STACK_MEAN_TOL = 5e-4, 2e-5
# the reference embedding, a tanh-bounded GRU state (measured 3.2e-5, the
# bf16 - float32 gap 4.6e-4)
EMBED_TOL = 1e-4


def t32(a):
    return torch.from_numpy(np.array(a, np.float32))


def flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def init_ref_encoder(b, t, seed=5):
    rng = np.random.default_rng(seed)
    mel = rng.uniform(0, 1, (b, t, NUM_MELS)).astype(np.float32)
    jcfg = JGSTConfig(**GST_KW)
    model = JRefEnc(jcfg, NUM_MELS)
    variables = jax.jit(lambda x: model.init({"params": jax.random.PRNGKey(seed)}, x, None,
                                             train=False))(jnp.zeros((1, 64, NUM_MELS)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    for i in range(len(jcfg.ref_conv_channels)):
        c = stats[f"bn_{i}"]["mean"].shape[0]
        stats[f"bn_{i}"]["mean"] = rng.normal(0, 0.3, (c,)).astype(np.float32)
        stats[f"bn_{i}"]["var"] = rng.uniform(0.5, 2.0, (c,)).astype(np.float32)
    m = ReferenceEncoder(GSTConfig(**GST_KW), NUM_MELS)
    load_flat(m, {**flatten(params, "params"), **flatten(stats, "batch_stats")})
    return jcfg, params, stats, mel, m


@pytest.fixture(scope="module")
def refenc_case():
    """The flagship stack at (2, 128, 80), lengths [128, 77], and JAX's
    batched stack in float32 and bf16 on the masked mel."""
    jcfg, params, stats, mel, m = init_ref_encoder(2, 128)
    lens = np.array([128, 77], np.int32)
    masked = mel * (np.arange(128)[None, :] < lens[:, None])[..., None]
    n = len(GST_KW["ref_conv_channels"])
    kernels = [jnp.asarray(params[f"conv_{i}"]["kernel"]) for i in range(n)]
    folded = [jrefenc.fold_bn(params[f"bn_{i}"], stats[f"bn_{i}"]) for i in range(n)]
    jax_stack = {bf16: np.asarray(jrefenc.refenc_stack_pallas_batched(
        jnp.asarray(masked), kernels, [s for s, _ in folded], [b for _, b in folded],
        interpret=True, bf16=bf16)) for bf16 in (False, True)}
    return dict(jcfg=jcfg, params=params, stats=stats, mel=mel, lens=lens, m=m,
                jax_stack=jax_stack)


def port_stack_args(m):
    kernels, scales, biases = [], [], []
    for i in range(len(GST_KW["ref_conv_channels"])):
        bn = getattr(m, f"bn_{i}")
        sc, bi = trefenc.fold_bn(bn.scale, bn.bias, bn.mean, bn.var)
        kernels.append(getattr(m, f"conv_{i}").kernel)
        scales.append(sc)
        biases.append(bi)
    return kernels, scales, biases


@pytest.mark.parametrize("fn", ["refenc_stack_plain", "refenc_stack"])
def test_refenc_stack_bf16_matches_pallas_batched_bf16(refenc_case, fn):
    c = refenc_case
    with torch.no_grad():
        got = getattr(trefenc, fn)(t32(c["mel"]), *port_stack_args(c["m"]),
                                   lengths=torch.from_numpy(c["lens"]), bf16=True).numpy()
    want, f32 = c["jax_stack"][True], c["jax_stack"][False]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=STACK_TOL)
    assert np.abs(got - want).mean() < STACK_MEAN_TOL
    # the bf16 function, not the float32 one
    assert np.abs(got - f32).mean() > 5 * STACK_MEAN_TOL


def test_ref_encoder_bf16_matches_ref_encoder_pallas_bf16(refenc_case):
    c = refenc_case
    want = np.asarray(jrefenc.ref_encoder_pallas(
        c["params"], c["stats"], c["jcfg"], jnp.asarray(c["mel"]), jnp.asarray(c["lens"]),
        interpret=True, batched=True, bf16=True))
    f32 = np.asarray(jrefenc.ref_encoder_pallas(
        c["params"], c["stats"], c["jcfg"], jnp.asarray(c["mel"]), jnp.asarray(c["lens"]),
        interpret=True, batched=True, bf16=False))
    with torch.no_grad():
        got = trefenc.ref_encoder(c["m"], t32(c["mel"]), torch.from_numpy(c["lens"]),
                                  bf16=True).numpy()
        none = trefenc.ref_encoder(c["m"], t32(c["mel"]), torch.from_numpy(c["lens"])).numpy()
    np.testing.assert_allclose(got, want, atol=EMBED_TOL)
    assert np.abs(got - f32).max() > 2 * EMBED_TOL
    # None on CPU tensors is float32: JAX's interpret-mode function
    np.testing.assert_allclose(none, f32, atol=1e-5)


@pytest.mark.parametrize("b", [1, 8, 32, 64, 96])
@pytest.mark.parametrize("t", [64, 128, 256, 512])
def test_batched_form_selection_matches_jax(b, t):
    channels = list(GSTConfig().ref_conv_channels)
    assert trefenc.refenc_batched_supported(t, len(channels)) == \
        jrefenc.refenc_batched_supported(t, len(channels))
    assert trefenc.refenc_batched_vmem_ok(b, t, NUM_MELS, channels) == \
        jrefenc.refenc_batched_vmem_ok(b, t, NUM_MELS, channels)


def test_bf16_none_resolves_as_jax_on_its_accelerator():
    """None: float32 for CPU tensors; for a CUDA tensor, bf16 exactly where
    JAX picks the batched form (a stand-in object carries the device and
    shape: this machine has no card)."""
    channels = list(GSTConfig().ref_conv_channels)

    def on(kind, shape):
        return types.SimpleNamespace(device=torch.device(kind), shape=shape)

    assert not trefenc.resolve_bf16(None, torch.zeros(8, 256, NUM_MELS), channels)
    assert trefenc.resolve_bf16(None, on("cuda", (8, 256, NUM_MELS)), channels)
    assert trefenc.resolve_bf16(None, on("cuda", (32, 128, NUM_MELS)), channels)
    assert not trefenc.resolve_bf16(None, on("cuda", (8, 101, NUM_MELS)), channels)
    assert trefenc.resolve_bf16(None, on("cuda", (96, 128, NUM_MELS)), channels) == \
        jrefenc.refenc_batched_vmem_ok(96, 128, NUM_MELS, channels)
    assert not trefenc.resolve_bf16(False, on("cuda", (8, 256, NUM_MELS)), channels)
    assert DeviceFeatureExtractor(AudioConfig(), "cpu").bf16 is False
    assert DeviceFeatureExtractor(AudioConfig(), "cpu", bf16=True).bf16 is True


# the STFT's bf16 mode at a small n_fft and at the flagship's
STFT_CONFIGS = [dict(n_fft=512, hop_length=128, win_length=512),
                dict(n_fft=2048, hop_length=256, win_length=1024)]
# normalized dB: loud bins (mel above 0.5 of the [0, 1] range), every bin, and
# the mean; a quiet bin's flip is amplified by the log (measured 3e-7, 6.5e-4
# and 2.6e-7; the bf16 - float32 gap's mean 4-6e-4)
LOUD_TOL, ALL_TOL, MEAN_TOL = 1e-5, 2e-3, 1e-5


@pytest.mark.parametrize("kw", STFT_CONFIGS)
def test_stft_bf16_matches_pallas_resident_bf16(kw):
    jcfg, cfg = JAudioConfig(**kw), AudioConfig(**kw)
    rng = np.random.default_rng(7)
    frames = 24
    length = (frames - 1) * cfg.hop_length + cfg.n_fft
    t = np.arange(length - cfg.n_fft) / cfg.sample_rate
    batch = []
    for _ in range(2):
        wav = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 400) * t) \
            + 0.05 * rng.standard_normal(t.size)
        pre = jref.preemphasis(wav, cfg.preemphasis)
        batch.append(np.pad(pre, cfg.n_fft // 2, mode="reflect").astype(np.float32))
    batch = np.stack(batch)
    want = [np.asarray(x) for x in stft_features_pallas_resident(
        jnp.asarray(batch), jcfg, interpret=True, bf16=True, tile_f=8)]
    f32 = [np.asarray(x) for x in stft_features_pallas_resident(
        jnp.asarray(batch), jcfg, interpret=True, bf16=False, tile_f=8)]
    for fn in (tstft.stft_features_plain, tstft.stft_features):
        got = [x.numpy() for x in fn(torch.from_numpy(batch), cfg, bf16=True)]
        for g, w, f in zip(got, want, f32):
            assert g.shape == w.shape
            loud = w > 0.5
            assert loud.any()
            assert np.abs(g - w)[loud].max() < LOUD_TOL
            assert np.abs(g - w).max() < ALL_TOL
            assert np.abs(g - w).mean() < MEAN_TOL
            # the bf16 function, not the float32 one
            assert np.abs(g - f).mean() > 10 * MEAN_TOL
    # nor K3′'s bf16 bases, whose mel product stays float32
    bases = tstft.stft_features_plain(torch.from_numpy(batch), cfg, bf16_bases=True)[0].numpy()
    assert np.abs(bases - want[0]).mean() > 10 * np.abs(got[0] - want[0]).mean()


def test_extractor_resident_route_bf16_is_k3s_bf16_mode():
    """The resident route computes K3's bf16 mode where asked (on the card by
    default); the CPU default stays float32."""
    cfg = AudioConfig(n_fft=512, hop_length=128, win_length=512)
    rng = np.random.default_rng(3)
    wavs = [rng.uniform(-0.5, 0.5, n).astype(np.float32) for n in (1000, 2500)]
    got = DeviceFeatureExtractor(cfg, "cpu", batch_size=2, frame_bucket=8,
                                 bf16=True).extract(wavs)
    f32 = DeviceFeatureExtractor(cfg, "cpu", batch_size=2, frame_bucket=8).extract(wavs)
    pad = cfg.n_fft // 2
    for w, (mel, lin), (mel32, _) in zip(wavs, got, f32):
        pre = np.pad(jref.preemphasis(np.asarray(w, np.float64), cfg.preemphasis), pad,
                     mode="reflect").astype(np.float32)
        want = tstft.stft_features_plain(torch.from_numpy(pre[None]), cfg, bf16=True)
        np.testing.assert_allclose(mel, want[0][0].numpy(), atol=1e-6)
        np.testing.assert_allclose(lin, want[1][0].numpy(), atol=1e-6)
        assert np.abs(mel - mel32).max() > 1e-3
