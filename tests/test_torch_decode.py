"""K4 (fused decode, Bahdanau and location-sensitive): the port's plain
version against ``decode_scan_pallas(interpret=True, use_dropout=False)`` and
the flax ``Decoder.decode(deterministic_prenet=True)`` at atol 1e-4 (the
contract of test_decode_pallas.py), including padded rows; the packed layout
with the folded location taps; and the Philox dropout stream the kernel and
the plain version share."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.config import AttentionConfig as JAttn
from gst_tacotron_tpu.config import DecoderConfig as JDec
from gst_tacotron_tpu.models.decoder import Decoder as JDecoder
from gst_tacotron_tpu.ops.decode_pallas import decode_scan_pallas, pack_decoder_weights
from gst_tacotron_tpu_torch.config import AttentionConfig, DecoderConfig
from gst_tacotron_tpu_torch.models.decoder import Decoder
from gst_tacotron_tpu_torch.ops import decode as tdecode
from gst_tacotron_tpu_torch.ops import philox
from gst_tacotron_tpu_torch.weights import load_flat

torch.set_num_threads(2)

NUM_MELS = 8
MEM_DIM = 16
DEC_KW = dict(prenet_dims=(16, 8), attention_rnn_dim=16, decoder_rnn_dim=16,
              num_decoder_rnn_layers=2, reduction_factor=2, max_decode_steps=6,
              use_stop_token=True, stop_threshold=0.5)
ATTN_KW = dict(kind="bahdanau", dim=16)


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


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(0)
    jdec = JDecoder(JDec(**DEC_KW), JAttn(**ATTN_KW), NUM_MELS, MEM_DIM)
    memory = rng.standard_normal((3, 9, MEM_DIM)).astype(np.float32)
    variables = jdec.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(memory), jnp.array([9, 6, 1]), jnp.zeros((3, 8, NUM_MELS)),
        method=jdec.teacher_forced)
    # nonzero biases everywhere so every bias term is exercised
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (rng.normal(0, 0.2, x.shape).astype(np.float32)
                                   if x.ndim == 1 else 0.0), variables["params"])
    dec = Decoder(DecoderConfig(**DEC_KW), AttentionConfig(**ATTN_KW), NUM_MELS, MEM_DIM)
    load_flat(dec, flatten(params, "params"))
    return jdec, {"params": params}, dec, memory


def test_decoder_decode_matches_flax(built):
    jdec, variables, dec, memory = built
    lengths = np.array([9, 6, 1], np.int32)
    ref = jdec.apply(variables, jnp.asarray(memory), jnp.asarray(lengths),
                     deterministic_prenet=True, method=jdec.decode,
                     rngs={"dropout": jax.random.PRNGKey(9)})
    with torch.no_grad():
        got = dec.decode(t32(memory), torch.from_numpy(lengths), deterministic_prenet=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


@pytest.mark.parametrize("lengths", [[9, 6, 1], [9, 0, 4]])
def test_plain_matches_pallas_kernel(built, lengths):
    jdec, variables, dec, memory = built
    lengths = np.array(lengths, np.int32)
    cell_params = variables["params"]["cell"]
    keys = jdec.apply(variables, jnp.asarray(memory),
                      method=lambda m, mem: m.cell.precompute_keys(mem))
    mask = jnp.arange(memory.shape[1])[None, :] < jnp.asarray(lengths)[:, None]
    jpacked = pack_decoder_weights(cell_params, NUM_MELS, 2, DEC_KW["prenet_dims"])
    ref = decode_scan_pallas(jpacked, jnp.asarray(memory), keys, mask,
                             dec_cfg=JDec(**DEC_KW), attn_cfg=JAttn(**ATTN_KW),
                             num_mels=NUM_MELS, steps=6, use_dropout=False,
                             interpret=True)
    packed = dec.cell.pack()
    assert set(jpacked) == set(packed)
    assert packed["loca"].shape == (1, ATTN_KW["dim"]) and not packed["loca"].any()
    for k, v in packed.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jpacked[k]), err_msg=k)
    got = tdecode.decode_scan(packed, t32(memory), t32(np.asarray(keys)),
                              torch.from_numpy(lengths), dec_cfg=DecoderConfig(**DEC_KW),
                              attn_cfg=AttentionConfig(**ATTN_KW), num_mels=NUM_MELS,
                              steps=6)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


def test_dropout_stream_is_seeded(built):
    _, _, dec, memory = built
    lengths = torch.tensor([9, 6, 1])
    with torch.no_grad():
        a = dec.decode(t32(memory), lengths, seed=1)
        b = dec.decode(t32(memory), lengths, seed=1)
        c = dec.decode(t32(memory), lengths, seed=2)
        det = dec.decode(t32(memory), lengths, deterministic_prenet=True)
    assert all(torch.isfinite(x).all() for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0], det[0])


def test_philox_known_answers_and_uniforms():
    # Random123's known-answer vectors for Philox4x32-10, through numpy
    # uint64 arrays and torch int64 tensors alike
    answers = [((0, 0, 0, 0), (0, 0), [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
               ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
                [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD])]
    for ctr, key, want in answers:
        out = philox.philox4x32_10([np.array([c], np.uint64) for c in ctr], key)
        assert [int(x[0]) for x in out] == want
        out = philox.philox4x32_10([torch.tensor([c]) for c in ctr], key)
        assert [int(x[0]) for x in out] == want
    # the extreme bit patterns stay strictly inside (0, 1) in float32
    ends = np.array([0, 0xFFFFFFFF], np.uint64)
    for u in (philox.uniform_open01(ends), philox.uniform_open01(torch.from_numpy(
            ends.astype(np.int64))).numpy()):
        assert u.dtype == np.float32 and 0.0 < u[0] < u[1] < 1.0
    u = tdecode.dropout_uniforms(seed=5, steps=50, layer=0, batch=4, units=256)
    assert u.dtype == np.float32 and u.shape == (50, 4, 256)
    assert u.min() > 0.0 and u.max() < 1.0
    assert abs(float((u >= 0.5).mean()) - 0.5) < 0.01
    assert not np.array_equal(u, tdecode.dropout_uniforms(6, 50, 0, 4, 256))
    assert not np.array_equal(u, tdecode.dropout_uniforms(5, 50, 1, 4, 256))


# -- location-sensitive attention (the cases of test_decode_pallas.py) --------

LSA_CASES = [(1, True), (2, False)]


@pytest.fixture(scope="module", params=LSA_CASES, ids=["r1-cumulative", "r2-prev-only"])
def built_lsa(request):
    r, cumulative = request.param
    dec_kw = {**DEC_KW, "reduction_factor": r}
    attn_kw = dict(kind="location_sensitive", dim=16, location_filters=4,
                   location_kernel_size=7, cumulative=cumulative)
    rng = np.random.default_rng(1)
    jdec = JDecoder(JDec(**dec_kw), JAttn(**attn_kw), NUM_MELS, MEM_DIM)
    memory = rng.standard_normal((3, 9, MEM_DIM)).astype(np.float32)
    variables = jdec.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(memory), jnp.array([9, 6, 1]), jnp.zeros((3, 4 * r, NUM_MELS)),
        method=jdec.teacher_forced)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (rng.normal(0, 0.2, x.shape).astype(np.float32)
                                   if x.ndim == 1 else 0.0), variables["params"])
    dec = Decoder(DecoderConfig(**dec_kw), AttentionConfig(**attn_kw), NUM_MELS, MEM_DIM)
    load_flat(dec, flatten(params, "params"))
    return jdec, {"params": params}, dec, memory, JDec(**dec_kw), JAttn(**attn_kw)


def test_lsa_decoder_decode_matches_flax(built_lsa):
    jdec, variables, dec, memory, _, _ = built_lsa
    lengths = np.array([9, 6, 1], np.int32)
    ref = jdec.apply(variables, jnp.asarray(memory), jnp.asarray(lengths),
                     deterministic_prenet=True, method=jdec.decode,
                     rngs={"dropout": jax.random.PRNGKey(9)})
    with torch.no_grad():
        got = dec.decode(t32(memory), torch.from_numpy(lengths), deterministic_prenet=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


@pytest.mark.parametrize("lengths", [[9, 6, 1], [9, 0, 4]])
def test_lsa_plain_matches_pallas_kernel(built_lsa, lengths):
    jdec, variables, dec, memory, jdec_cfg, jattn_cfg = built_lsa
    lengths = np.array(lengths, np.int32)
    keys = jdec.apply(variables, jnp.asarray(memory),
                      method=lambda m, mem: m.cell.precompute_keys(mem))
    mask = jnp.arange(memory.shape[1])[None, :] < jnp.asarray(lengths)[:, None]
    r = jdec_cfg.reduction_factor
    jpacked = pack_decoder_weights(variables["params"]["cell"], NUM_MELS, r,
                                   DEC_KW["prenet_dims"])
    ref = decode_scan_pallas(jpacked, jnp.asarray(memory), keys, mask, dec_cfg=jdec_cfg,
                             attn_cfg=jattn_cfg, num_mels=NUM_MELS, steps=6,
                             use_dropout=False, interpret=True)
    packed = dec.cell.pack()
    assert set(jpacked) == set(packed)
    c = 2 if jattn_cfg.cumulative else 1
    assert packed["loca"].shape == (7 * c, 16)
    for k, v in packed.items():
        # loca is a float32 product: torch's and numpy's sums may round apart
        np.testing.assert_allclose(v.numpy(), np.asarray(jpacked[k]), rtol=1e-6,
                                   atol=1e-7 if k == "loca" else 0, err_msg=k)
    got = tdecode.decode_scan(packed, t32(memory), t32(np.asarray(keys)),
                              torch.from_numpy(lengths), dec_cfg=dec.cfg,
                              attn_cfg=dec.attn_cfg, num_mels=NUM_MELS, steps=6)
    for g, r_ in zip(got, ref):
        assert g.shape == r_.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r_), atol=1e-4)


def test_lsa_location_term_moves_the_alignment(built_lsa):
    """With the folded taps zeroed, the LSA decode is the Bahdanau decode of
    the same weights (packed with Bahdanau's one zero tap); with them, the
    alignments differ."""
    _, _, dec, memory, _, _ = built_lsa
    lengths = torch.tensor([9, 6, 1])
    mem = t32(memory)
    with torch.no_grad():
        keys = dec.cell.precompute_keys(mem)
        packed = dec.cell.pack()
        kw = dict(dec_cfg=dec.cfg, num_mels=NUM_MELS, steps=6)
        lsa = tdecode.decode_scan(packed, mem, keys, lengths, attn_cfg=dec.attn_cfg, **kw)
        zero = tdecode.decode_scan({**packed, "loca": torch.zeros_like(packed["loca"])},
                                   mem, keys, lengths, attn_cfg=dec.attn_cfg, **kw)
        bahdanau = tdecode.decode_scan({**packed, "loca": packed["loca"].new_zeros(1, 16)},
                                       mem, keys, lengths,
                                       attn_cfg=AttentionConfig(kind="bahdanau", dim=16), **kw)
    assert all(torch.equal(x, y) for x, y in zip(zero, bahdanau))
    assert not torch.allclose(lsa[2], bahdanau[2], atol=1e-4)
