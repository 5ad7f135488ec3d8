"""Parameter partitioning rules (counterpart of
``gst_tacotron_tpu/parallel/sharding.py``): tensor parallelism over the
mesh's ``model`` axis.

Most parameters replicate. The rules below, regexes over a parameter's flax
path (its state-dict key with ``/`` for ``.``, ``weights.state_key_to_flat``
without the collection), shard the output dimension of:
  * the style-token attention's query, key and value projections;
  * the decoder's frame projection, decoder-input projection and the
    kernels of its residual GRUs;
  * the encoder embedding, on its feature dimension;
  * the WaveRNN's GRU, fc1 and fc2 kernels and recurrent kernels, and the
    standalone vocoder tree's cond_proj.
Biases stay replicated. A spec is a plain tuple over the tensor's
dimensions: ``(None, "model")`` shards the last, ``()`` replicates.

Storage is sharded and use gathered (``shard_params``): a rank stores only
its column block of each ruled kernel, and its Adam moments for that block;
at use (``module.kernel``, a ``torch.nn.utils.parametrize`` parametrization)
the blocks are all-gathered into the whole kernel, and the backward keeps
this rank's columns of the whole kernel's gradient. The ranks of a model
group compute the same forward on the same rows, so that is GSPMD's
function with the rules' memory: the parametrized key
``<module>.parametrizations.<name>.original`` holds the block, and
``canonical_key`` maps it back to ``<module>.<name>``.
"""

from __future__ import annotations

import contextlib
import re
from typing import Callable, Dict, FrozenSet, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn.utils import parametrize

from ..models.modules import data_parallel
from ..weights import state_key_to_flat
from .mesh import (MODEL_AXIS, Mesh, agree_over_model, all_gather, column_block,
                   gather_columns, replicate_tree, sum_over_data)

_COLUMNS = (None, MODEL_AXIS)

# (path regex, spec by rank)
_RULES: List[Tuple[str, Dict[int, tuple]]] = [
    (r".*stl/(query_proj|key_proj|value_proj)/kernel$", {2: _COLUMNS}),
    (r".*decoder/cell/frame_proj/kernel$", {2: _COLUMNS}),
    (r".*decoder/cell/decoder_input_proj/kernel$", {2: _COLUMNS}),
    (r".*decoder/cell/decoder_rnn_\d+/kernel$", {2: _COLUMNS}),
    # feature-dim sharding (vocab sizes are small and rarely divisible)
    (r".*encoder/embedding/embedding$", {2: _COLUMNS}),
    # WaveRNN: an embedded ``wavernn/...`` subtree and the standalone
    # vocoder tree (anchored at the root, so the GST reference encoder's
    # nested ``.../gru/...`` never matches)
    (r".*wavernn.*/(gru|fc1|fc2)/(kernel|recurrent_kernel)$", {2: _COLUMNS}),
    (r"^(gru|fc1|fc2|cond_proj)/(kernel|recurrent_kernel)$", {2: _COLUMNS}),
]

_PARAMETRIZED = re.compile(r"(^|\.)parametrizations\.(\w+)\.original$")


def spec_for_path(path: str, ndim: int) -> tuple:
    """The spec of the parameter at flax ``path`` with ``ndim`` dimensions."""
    for pattern, by_rank in _RULES:
        if re.match(pattern, path) and ndim in by_rank:
            return by_rank[ndim]
    return ()


def canonical_key(key: str) -> str:
    """A state-dict key with a parametrized block's key mapped back to the
    module's own name (``a.parametrizations.kernel.original`` -> ``a.kernel``)."""
    return _PARAMETRIZED.sub(r"\1\2", key)


def param_path(key: str) -> str:
    """The flax path of a state-dict key (the rules' subject)."""
    return state_key_to_flat(canonical_key(key)).partition("/")[2]


def named_parameters(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s parameters under their canonical keys (a sharded kernel's
    block under the kernel's key)."""
    return {canonical_key(k): p for k, p in model.named_parameters()}


def param_shardings(params: Mapping[str, torch.Tensor]) -> Dict[str, tuple]:
    """{key: spec} of a {state-dict key: tensor} mapping (the specs do not
    depend on the mesh)."""
    return {canonical_key(k): spec_for_path(param_path(k), v.dim()) for k, v in params.items()}


def describe_sharding(params: Mapping[str, torch.Tensor]) -> Dict[str, str]:
    """Human-readable {flax path: spec} of every parameter (debugging)."""
    return {param_path(k): str(spec_for_path(param_path(k), v.dim()))
            for k, v in params.items()}


class _ColumnBlock(nn.Module):
    """The parametrization of a ruled kernel: storage is this rank's column
    block, use the whole kernel gathered over the model group."""

    def __init__(self, group, index: int, count: int):
        super().__init__()
        self.group, self.index, self.count = group, index, count

    def forward(self, block: torch.Tensor) -> torch.Tensor:
        return gather_columns(block, self.group, self.index, self.count)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return column_block(full, self.index, self.count).clone()


def shard_params(model: nn.Module, mesh: Mesh) -> FrozenSet[str]:
    """Store ``model``'s ruled kernels sharded over the model axis (each
    rank its column block, from the value it holds: identical on every rank
    of a model group); returns the keys of the sharded parameters. A model
    axis of one rank shards nothing."""
    count = mesh.shape[MODEL_AXIS]
    if count == 1:
        return frozenset()
    _, index = mesh.coords()
    modules = dict(model.named_modules())
    sharded = []
    for key, spec in param_shardings(dict(model.named_parameters())).items():
        if MODEL_AXIS not in spec:
            continue
        owner, _, name = key.rpartition(".")
        parametrize.register_parametrization(
            modules[owner], name, _ColumnBlock(mesh.model_group, index, count), unsafe=True)
        sharded.append(key)
    return frozenset(sharded)


def on_mesh(model: nn.Module, mesh: Optional[Mesh]):
    """The context of a forward under ``mesh``: the modules compute this
    rank's shard of the global batch, and each sharded kernel is gathered
    once (nothing without a mesh)."""
    if mesh is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(data_parallel(model, mesh.data_shard()))
    stack.enter_context(parametrize.cached())
    return stack


def step_gradients(mesh: Optional[Mesh], grads: Dict[str, torch.Tensor],
                   sharded: FrozenSet[str]) -> Dict[str, torch.Tensor]:
    """The step's gradients from this rank's own: summed over the data
    axis, then, under a model axis, the replicated parameters' gradients
    taken from the first rank of the model group. The ranks of a model
    group compute the same forward, so those copies are equal in exact
    arithmetic; a backward that is not deterministic (atomics on the card)
    can leave them a few ulps apart, and Adam would let the replicated
    parameters drift apart from there. The broadcast keeps them bit-equal."""
    grads = sum_over_data(mesh, grads)
    replicated = {k: g for k, g in grads.items() if k not in sharded}
    return {**grads, **agree_over_model(mesh, replicated)}


def whole_copy(model: nn.Module, mesh: Mesh, build: Callable[[], nn.Module]) -> nn.Module:
    """``model`` itself when none of its kernels is sharded; else ``build()``
    (a model of the same kind) loaded with ``model``'s state, the sharded
    kernels gathered over the model axis (a collective: every rank calls
    it)."""
    sharded = frozenset(canonical_key(k) for k, _ in model.named_parameters()
                        if canonical_key(k) != k)
    if not sharded:
        return model
    whole = build()
    whole.load_state_dict(full_model_state(model, sharded, mesh))
    return whole


def state_shardings(state) -> Dict[str, Dict[str, tuple]]:
    """{"params", "mu", "nu": {key: spec}} of a ``train.TrainState``: Adam's
    moments follow their parameter; the buffers, the count, the step and
    the seed replicate."""
    specs = param_shardings(dict(state.model.named_parameters()))
    return {"params": specs, "mu": dict(specs), "nu": dict(specs)}


def local_blocks(tree: Mapping[str, torch.Tensor], sharded: FrozenSet[str], mesh: Mesh
                 ) -> Dict[str, torch.Tensor]:
    """This rank's blocks of a whole {canonical key: tensor} tree."""
    _, index = mesh.coords()
    count = mesh.shape[MODEL_AXIS]
    return {k: column_block(v, index, count).contiguous() if k in sharded else v
            for k, v in tree.items()}


def gather_tree(tree: Mapping[str, torch.Tensor], sharded: FrozenSet[str], mesh: Mesh
                ) -> Dict[str, torch.Tensor]:
    """Whole tensors of a {canonical key: tensor} tree whose ``sharded``
    entries are this rank's blocks (a collective over the model group)."""
    return {k: all_gather(v.detach(), mesh.model_group, dim=-1) if k in sharded else v
            for k, v in tree.items()}


def place_state(state, mesh: Mesh):
    """Place a ``train.TrainState`` on ``mesh`` in place and return it: rank
    0's parameters, buffers and Adam moments on every rank (init is
    deterministic per seed, so they are equal anyway), then the ruled
    kernels and their moments sharded over the model axis."""
    model = state.model
    own = model.state_dict()
    with torch.no_grad():
        for k, v in replicate_tree(own, mesh).items():
            own[k].copy_(v)
        for name in ("mu", "nu"):
            moments = getattr(state.opt, name)
            moments.update(replicate_tree(moments, mesh))
    state.sharded = shard_params(model, mesh)
    for name in ("mu", "nu"):
        setattr(state.opt, name, local_blocks(getattr(state.opt, name), state.sharded, mesh))
    state.mesh = mesh
    return state


def full_model_state(model: nn.Module, sharded: FrozenSet[str], mesh: Mesh
                     ) -> Dict[str, torch.Tensor]:
    """``model``'s state dict under canonical keys, sharded kernels whole."""
    tree = {canonical_key(k): v for k, v in model.state_dict().items()}
    return gather_tree(tree, sharded, mesh) if sharded else tree


def load_model_state(model: nn.Module, full: Mapping[str, torch.Tensor],
                     sharded: FrozenSet[str], mesh: Mesh) -> None:
    """Copy a whole (canonical-key) state dict into ``model``, each sharded
    kernel's block into its storage."""
    if not sharded:
        model.load_state_dict(full)
        return
    own = model.state_dict()
    if {canonical_key(k) for k in own} != set(full):
        raise KeyError("the saved state's keys are not the model's")
    blocks = local_blocks({canonical_key(k): full[canonical_key(k)] for k in own}, sharded, mesh)
    with torch.no_grad():
        for k, v in own.items():
            v.copy_(blocks[canonical_key(k)])

