"""K1 (GRU scan): the port's plain version against the flax GRU scan and
``gru_scan_pallas`` in interpret mode (the contract of test_gru_pallas.py,
atol 1e-5); the port's GRU/BiGRU modules against flax's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.models.rnn import GRU as JGRU
from gst_tacotron_tpu.models.rnn import BiGRU as JBiGRU
from gst_tacotron_tpu.ops.gru_pallas import gru_scan_pallas
from gst_tacotron_tpu_torch.models.rnn import GRU, BiGRU, GRUCell
from gst_tacotron_tpu_torch.ops import gru as tgru
from gst_tacotron_tpu_torch.weights import load_flat

torch.set_num_threads(2)


def t32(a):
    return torch.from_numpy(np.array(a, np.float32))


def make(b=3, t=7, d=5, h=4, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((b, t, d)).astype(np.float32)
    lengths = rng.integers(2, t + 1, (b,)).astype(np.int32)
    variables = JGRU(h, allow_pallas=False).init(
        jax.random.PRNGKey(seed), jnp.asarray(xs), jnp.asarray(lengths))
    p = {k: np.asarray(v) for k, v in variables["params"].items()}
    # nonzero biases so both bias vectors are exercised
    p["bias"] = rng.normal(0, 0.3, p["bias"].shape).astype(np.float32)
    p["recurrent_bias"] = rng.normal(0, 0.3, p["bias"].shape).astype(np.float32)
    return p, xs, lengths


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_plain_matches_flax_scan_and_pallas(reverse, with_lengths):
    h = 4
    p, xs, lengths = make(h=h)
    lens = lengths if with_lengths else None
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ys_ref, fin_ref = JGRU(h, reverse=reverse, allow_pallas=False).apply(
        {"params": jp}, jnp.asarray(xs), None if lens is None else jnp.asarray(lens),
        train=True)
    ys_k, fin_k = gru_scan_pallas(
        jnp.asarray(xs), jnp.zeros((xs.shape[0], h)), jp["kernel"], jp["bias"],
        jp["recurrent_kernel"], jp["recurrent_bias"],
        lengths=None if lens is None else jnp.asarray(lens), reverse=reverse,
        interpret=True)
    ys, fin = tgru.gru_scan(
        t32(xs), torch.zeros(xs.shape[0], h), t32(p["kernel"]), t32(p["bias"]),
        t32(p["recurrent_kernel"]), t32(p["recurrent_bias"]),
        lengths=None if lens is None else torch.from_numpy(lens), reverse=reverse)
    for ref in ((ys_ref, fin_ref), (ys_k, fin_k)):
        np.testing.assert_allclose(ys.numpy(), np.asarray(ref[0]), atol=1e-5)
        np.testing.assert_allclose(fin.numpy(), np.asarray(ref[1]), atol=1e-5)


@pytest.mark.parametrize("h,reverse", [(256, False), (256, True), (300, False)])
def test_plain_matches_pallas_past_h_128(h, reverse):
    """H = 256 (K1's 16-weights-a-lane form on the card) and 300 (its
    streamed form): the port's scan against ``gru_scan_pallas`` in interpret
    mode, which takes any H, at test_gru_pallas.py's 1e-5."""
    p, xs, lengths = make(b=2, t=5, d=6, h=h, seed=h)
    p = {k: v * np.float32(0.5) for k, v in p.items()}   # keep the gates off saturation
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ys_k, fin_k = gru_scan_pallas(
        jnp.asarray(xs), jnp.zeros((xs.shape[0], h)), jp["kernel"], jp["bias"],
        jp["recurrent_kernel"], jp["recurrent_bias"], lengths=jnp.asarray(lengths),
        reverse=reverse, interpret=True)
    ys, fin = tgru.gru_scan(
        t32(xs), torch.zeros(xs.shape[0], h), t32(p["kernel"]), t32(p["bias"]),
        t32(p["recurrent_kernel"]), t32(p["recurrent_bias"]),
        lengths=torch.from_numpy(lengths), reverse=reverse)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_k), atol=1e-5)
    np.testing.assert_allclose(fin.numpy(), np.asarray(fin_k), atol=1e-5)
    assert tgru.launch_plan(2, h)["ks"] == (16 if h <= 256 else 0)


@pytest.mark.parametrize("with_lengths", [True, False])
def test_bigru_scan_matches_two_pallas_scans(with_lengths):
    """``bigru_scan`` (both directions, one kernel launch on the card) on the
    CPU: the forward and reverse ``gru_scan_pallas`` in interpret mode,
    concatenated, with both finals."""
    h = 4
    pf, xs, lengths = make(h=h, seed=3)
    pb, _, _ = make(h=h, seed=4)
    lens = lengths if with_lengths else None
    refs = []
    for p, rev in ((pf, False), (pb, True)):
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        refs.append(gru_scan_pallas(
            jnp.asarray(xs), jnp.zeros((xs.shape[0], h)), jp["kernel"], jp["bias"],
            jp["recurrent_kernel"], jp["recurrent_bias"],
            lengths=None if lens is None else jnp.asarray(lens), reverse=rev, interpret=True))
    dirs = [(torch.zeros(xs.shape[0], h), *(t32(p[k]) for k in
             ("kernel", "bias", "recurrent_kernel", "recurrent_bias"))) for p in (pf, pb)]
    ys, (f_final, b_final) = tgru.bigru_scan(
        t32(xs), *dirs, lengths=None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(ys.numpy(), np.concatenate([np.asarray(refs[0][0]),
                                                           np.asarray(refs[1][0])], -1),
                               atol=1e-5)
    np.testing.assert_allclose(f_final.numpy(), np.asarray(refs[0][1]), atol=1e-5)
    np.testing.assert_allclose(b_final.numpy(), np.asarray(refs[1][1]), atol=1e-5)


def test_masked_steps_hold_state_and_repeat_it():
    p, xs, lengths = make(b=2, t=6)
    lens = np.array([6, 3], np.int32)
    args = [t32(p[k]) for k in ("kernel", "bias", "recurrent_kernel", "recurrent_bias")]
    ys, fin = tgru.gru_scan_plain(t32(xs), torch.zeros(2, 4), *args,
                                  lengths=torch.from_numpy(lens))
    assert torch.equal(ys[1, 3:], ys[1, 2:3].expand(3, -1))
    assert torch.equal(fin[1], ys[1, 2])
    ys_r, fin_r = tgru.gru_scan_plain(t32(xs), torch.zeros(2, 4), *args,
                                      lengths=torch.from_numpy(lens), reverse=True)
    # reverse: the padded steps come first and hold h0 (zeros)
    assert torch.equal(ys_r[1, 3:], torch.zeros(3, 4))
    assert torch.equal(fin_r[1], ys_r[1, 0])


def test_bigru_module_matches_flax():
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((2, 5, 3)).astype(np.float32)
    lengths = np.array([5, 3], np.int32)
    jm = JBiGRU(6, allow_pallas=False)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs), jnp.asarray(lengths))
    ref, (rf, rb) = jm.apply(variables, jnp.asarray(xs), jnp.asarray(lengths), train=True)
    m = BiGRU(3, 6)
    flat = {f"params/{d}/{k}": np.asarray(v)
            for d in ("forward", "backward") for k, v in variables["params"][d].items()}
    load_flat(m, flat)
    with torch.no_grad():
        out, (f, b) = m(t32(xs), torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), atol=1e-5)


def test_gru_cell_matches_flax_cell():
    from gst_tacotron_tpu.models.rnn import GRUCell as JCell

    rng = np.random.default_rng(2)
    h0 = rng.standard_normal((3, 4)).astype(np.float32)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    variables = JCell(4).init(jax.random.PRNGKey(1), jnp.asarray(h0), jnp.asarray(x))
    ref, _ = JCell(4).apply(variables, jnp.asarray(h0), jnp.asarray(x))
    cell = GRUCell(5, 4)
    load_flat(cell, {f"params/{k}": np.asarray(v) for k, v in variables["params"].items()})
    with torch.no_grad():
        got, _ = cell(t32(h0), t32(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_gru_module_plain_flag_and_cpu_path_agree():
    p, xs, lengths = make()
    m = GRU(5, 4)
    load_flat(m, {f"params/{k}": v for k, v in p.items()})
    with torch.no_grad():
        a = m(t32(xs), torch.from_numpy(lengths))
        b = m(t32(xs), torch.from_numpy(lengths), plain=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
