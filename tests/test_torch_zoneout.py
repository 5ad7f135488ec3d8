"""``models/rnn.py::ZoneoutGRUCell`` against the JAX package's (CPU): the
deterministic branch (h' = z h + (1 - z) h_new) within 1e-6; the stochastic
branch given the same Bernoulli(z) mask (JAX's ``jnp.where(keep_old, h,
h_new)`` on the port's mask) within 1e-6, its mask drawn from the explicit
generator (the same seed gives the same state, the global stream is not
touched), and its keep rate within 0.02 of z over 64k units; the inner
cell's flax name ``GRUCell_0`` loads through ``weights.load_flat``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.models.rnn import ZoneoutGRUCell as JZoneoutGRUCell
from gst_tacotron_tpu_torch.models import ZoneoutGRUCell
from gst_tacotron_tpu_torch.weights import load_flat

from tests.test_torch_synth_configs import flatten_tree

torch.set_num_threads(2)

D, H, Z = 6, 8, 0.3


@pytest.fixture(scope="module")
def cells():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (4, D)).astype(np.float32)
    h = rng.normal(0, 1, (4, H)).astype(np.float32)
    jcell = JZoneoutGRUCell(H, zoneout=Z)
    variables = jcell.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x))
    cell = ZoneoutGRUCell(D, H, zoneout=Z)
    load_flat(cell, flatten_tree(variables))
    return jcell, variables, cell, x, h


def test_deterministic_branch_matches_jax(cells):
    jcell, variables, cell, x, h = cells
    ref, ref_out = jcell.apply(variables, jnp.asarray(h), jnp.asarray(x))
    got, out = cell(torch.from_numpy(h), torch.from_numpy(x))
    assert got is out
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_stochastic_branch_matches_jax_on_the_same_mask(cells):
    jcell, variables, cell, x, h = cells
    before = torch.random.get_rng_state()
    got, _ = cell(torch.from_numpy(h), torch.from_numpy(x), deterministic=False,
                  generator=torch.Generator().manual_seed(5))
    assert torch.equal(torch.random.get_rng_state(), before)
    keep_old = torch.rand((4, H), generator=torch.Generator().manual_seed(5)) < Z
    # JAX's new state with zoneout off, then its where() on the port's mask
    h_new = jcell.clone(zoneout=0.0).apply(variables, jnp.asarray(h), jnp.asarray(x))[0]
    ref = jnp.where(jnp.asarray(keep_old.numpy()), jnp.asarray(h), h_new)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    again, _ = cell(torch.from_numpy(h), torch.from_numpy(x), deterministic=False,
                    generator=torch.Generator().manual_seed(5))
    assert torch.equal(got, again)


def test_stochastic_keep_rate_and_generator_required(cells):
    _, _, cell, _, _ = cells
    h = torch.full((8192, H), 7.0)
    x = torch.zeros(8192, D)
    got, _ = cell(h, x, deterministic=False, generator=torch.Generator().manual_seed(0))
    rate = float((got == 7.0).float().mean())
    assert abs(rate - Z) < 0.02, rate
    with pytest.raises(ValueError, match="Generator"):
        cell(h, x, deterministic=False)
