"""The port's mesh and sharding rules (``gst_tacotron_tpu_torch/parallel``)
without processes, against the JAX package's ``parallel``:

* ``make_mesh`` shapes (the model axis over adjacent ranks) and its refusal
  of a model size that does not divide the ranks;
* ``process_data_shard`` on (2, 1), (1, 2) and (2, 2) grids: the ranks of a
  model group load the same rows;
* the ruled parameters equal the JAX ``spec_for_path``'s over every flat key
  of gst_lj's and gst_wavernn's parameters (the seq2seq tree and the
  standalone WaveRNN tree), and ``describe_sharding`` says so;
* the column-block storage of a sharded kernel: ``canonical_key``,
  ``column_block``, ``local_blocks``;
* ``initialize_distributed``'s checks (one process joins no group);
* ``place_tree`` keeps a rank's block, ``state_shardings`` gives Adam's
  moments their parameter's spec;
* ``shard_batch`` takes a rank's rows and refuses a batch that does not
  divide the data axis; ``fold_seed`` gives each data index its own seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gst_tacotron_tpu.config import get_preset as jget_preset
from gst_tacotron_tpu.models.wavernn import WaveRNN as JWaveRNN
from gst_tacotron_tpu.parallel.sharding import spec_for_path as jspec_for_path
from gst_tacotron_tpu.train import build_model as jbuild
from gst_tacotron_tpu_torch.config import get_preset, load_config
from gst_tacotron_tpu_torch.models.tacotron import GSTTacotron
from gst_tacotron_tpu_torch.models.wavernn import WaveRNN
from gst_tacotron_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS, describe_sharding,
                                             make_mesh, param_shardings, place_tree,
                                             process_data_shard, shard_batch, state_shardings)
from gst_tacotron_tpu_torch.parallel.distributed_synthesis import fold_seed
from gst_tacotron_tpu_torch.parallel.mesh import column_block
from gst_tacotron_tpu_torch.parallel.sharding import (canonical_key, local_blocks,
                                                      spec_for_path)
from gst_tacotron_tpu_torch.text import NUM_SYMBOLS

from tests.torch_dist_workers import run_ranks


def test_make_mesh_shapes_and_errors():
    mesh = make_mesh(2, ranks=range(8))
    assert mesh.shape == {DATA_AXIS: 4, MODEL_AXIS: 2}
    # the model axis over adjacent ranks
    assert mesh.ranks.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.coords(5) == (2, 1)
    assert make_mesh(1).shape == {DATA_AXIS: 1, MODEL_AXIS: 1}
    for bad in (3, 0):
        with pytest.raises(ValueError, match="does not divide"):
            make_mesh(bad, ranks=range(8))
    with pytest.raises(ValueError, match="not on the mesh"):
        mesh.coords(8)


@pytest.mark.parametrize("grid,expected", [
    ((2, 1), [(0, 2), (1, 2)]),
    ((1, 2), [(0, 1), (0, 1)]),
    ((2, 2), [(0, 2), (0, 2), (1, 2), (1, 2)]),
])
def test_process_data_shard(grid, expected):
    data, model = grid
    mesh = make_mesh(model, ranks=range(data * model))
    assert mesh.shape == {DATA_AXIS: data, MODEL_AXIS: model}
    assert [process_data_shard(mesh, r) for r in range(data * model)] == expected


def _jax_flat_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jax_flat_paths(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: len(tree.shape)}


def _jax_params(name):
    """{flax path: ndim} of the JAX package's parameters of preset ``name``:
    the seq2seq tree and, for a WaveRNN config, the vocoder's tree."""
    cfg = jget_preset(name)
    model = jbuild(cfg)
    tokens = jnp.zeros((1, 8), jnp.int32)
    mel = jnp.zeros((1, 16, cfg.model.num_mels), jnp.float32)
    kw = {"ref_mel": mel} if cfg.model.gst.enabled else {}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        tokens, jnp.array([8]), mel, train=False, **kw))
    trees = [shapes["params"]]
    if cfg.model.vocoder.kind == "wavernn":
        voc = JWaveRNN(cfg.model.vocoder, cfg.model.num_mels)
        hop = cfg.model.vocoder.wavernn_hop
        trees.append(jax.eval_shape(lambda: voc.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 2, cfg.model.num_mels)),
            jnp.zeros((1, 2 * hop))))["params"])
    return [_jax_flat_paths(t) for t in trees]


def _port_params(name):
    cfg = get_preset(name)
    with torch.device("meta"):
        trees = [GSTTacotron(cfg.model, cfg.model.num_symbols or NUM_SYMBOLS)]
        if cfg.model.vocoder.kind == "wavernn":
            trees.append(WaveRNN(cfg.model.vocoder, cfg.model.num_mels))
    return [dict(m.named_parameters()) for m in trees]


@pytest.mark.parametrize("name", ["gst_lj", "gst_wavernn"])
def test_ruled_keys_equal_the_jax_rules(name):
    for jtree, ttree in zip(_jax_params(name), _port_params(name)):
        desc = describe_sharding(ttree)
        assert set(desc) == set(jtree), name          # one flax path per parameter
        jruled = {p for p, nd in jtree.items() if jspec_for_path(p, nd) != P()}
        assert jruled, name
        assert {p for p, spec in desc.items() if MODEL_AXIS in spec} == jruled
        specs = param_shardings(ttree)
        truled = [k for k, spec in specs.items() if spec]
        assert len(truled) == len(jruled)
        assert all(specs[k] == (None, MODEL_AXIS) for k in truled)


def test_spec_for_path():
    assert spec_for_path("decoder/cell/frame_proj/kernel", 2) == (None, MODEL_AXIS)
    assert spec_for_path("decoder/cell/frame_proj/bias", 1) == ()
    assert spec_for_path("gst/reference_encoder/gru/kernel", 2) == ()
    assert spec_for_path("gru/recurrent_kernel", 2) == (None, MODEL_AXIS)
    assert spec_for_path("cond_proj/kernel", 2) == (None, MODEL_AXIS)


def test_column_blocks_and_canonical_keys():
    assert canonical_key("decoder.cell.frame_proj.parametrizations.kernel.original") == \
        "decoder.cell.frame_proj.kernel"
    assert canonical_key("parametrizations.kernel.original") == "kernel"
    assert canonical_key("decoder.cell.frame_proj.bias") == "decoder.cell.frame_proj.bias"
    full = torch.arange(24.0).reshape(2, 12)
    blocks = [column_block(full, i, 3) for i in range(3)]
    assert torch.equal(torch.cat(blocks, -1), full)
    with pytest.raises(ValueError, match="do not divide"):
        column_block(full, 0, 5)
    mesh = make_mesh(2, ranks=[1, 0])   # a grid without a process group: its first rank
    tree = {"a.kernel": full, "a.bias": torch.ones(12)}
    got = local_blocks(tree, frozenset({"a.kernel"}), mesh)
    assert torch.equal(got["a.kernel"], full[:, :6]) and torch.equal(got["a.bias"], tree["a.bias"])


def test_initialize_distributed_arguments():
    """One process joins no group; a group needs the coordinator and an id
    in range."""
    import torch.distributed as dist

    from gst_tacotron_tpu_torch.parallel import initialize_distributed

    initialize_distributed(None, 1, None)
    initialize_distributed("localhost:1", None, 0)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(None, 2, 0)
    with pytest.raises(ValueError, match="not in"):
        initialize_distributed("localhost:1", 2, 2)


def test_place_tree_and_state_shardings():
    """Without a process group ``place_tree`` keeps this rank's column block
    of a ruled tensor (rank 0: the first); Adam's moments follow their
    parameter's spec."""
    from gst_tacotron_tpu_torch.train import init_state

    mesh = make_mesh(2, ranks=[0, 1])
    full = torch.arange(12.0).reshape(3, 4)
    got = place_tree({"w": full, "b": torch.ones(4)}, {"w": (None, MODEL_AXIS)}, mesh)
    assert torch.equal(got["w"], full[:, :2]) and torch.equal(got["b"], torch.ones(4))
    cfg = load_config("tests/fixtures/golden/config.json")
    _, state = init_state(cfg, "cpu")
    specs = state_shardings(state)
    assert specs["mu"] == specs["nu"] == specs["params"]
    assert specs["params"]["decoder.cell.frame_proj.kernel"] == (None, MODEL_AXIS)
    assert specs["params"]["decoder.cell.frame_proj.bias"] == ()


def test_shard_batch_and_fold_seed():
    mesh = make_mesh(1, ranks=[0, 1])
    batch = {"x": np.arange(8).reshape(4, 2), "y": torch.arange(4)}
    got = shard_batch(batch, mesh)
    np.testing.assert_array_equal(got["x"], batch["x"][:2])
    assert torch.equal(got["y"], torch.arange(2))
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch({"x": np.zeros(3)}, mesh)
    seeds = {fold_seed(5, i) for i in range(4)} | {fold_seed(6, 0)}
    assert len(seeds) == 5 and all(0 <= s < 2 ** 64 for s in seeds)
    assert fold_seed(5, 1) == fold_seed(5, 1)


def test_step_gradients_sum_over_data_and_agree_over_model():
    """(2, 2) mesh, ranks [[0, 1], [2, 3]]: the data axis sums (ranks 0+2,
    1+3); then the replicated gradient is the model group's first rank's on
    every rank, bit for bit, though the odd ranks' copies were an ulp off;
    the sharded block keeps its own sum."""
    got = run_ranks("step_gradients", 4, 2)
    for rank, g in enumerate(got):
        np.testing.assert_array_equal(g["bias"], np.full(3, 4.0, np.float32))
        np.testing.assert_array_equal(g["kernel"], np.full((2, 2), 40.0 if rank % 2 == 0
                                                           else 60.0, np.float32))
