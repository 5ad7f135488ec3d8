"""Same-seed training determinism (the contract of tests/test_determinism.py)
on the port's ``Trainer`` on the CPU, at tests/test_torch_train.py's
widths: two trainers with ``train.seed=7`` give bit-identical parameters,
BatchNorm statistics and Adam moments after 3 steps; ``train.seed=8``
diverges. ``tests/test_torch_card_train.py`` holds the same on the card at
gst_lj's published widths, with the step's CUDA graph replayed."""

import pytest
import torch

from gst_tacotron_tpu_torch.config import apply_overrides
from gst_tacotron_tpu_torch.data import generate_patterns, synthetic_utterances
from gst_tacotron_tpu_torch.train import Trainer

from tests.test_torch_train import port_cfg

torch.set_num_threads(2)

STEPS = 3


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    return port_cfg(tmp_path_factory)


@pytest.fixture(scope="module")
def patterns(tmp_path_factory, cfg):
    out = str(tmp_path_factory.mktemp("patterns"))
    generate_patterns(synthetic_utterances(6), cfg.audio, out)
    return out


def trained(cfg, patterns, work, seed):
    """Every tensor of the state after ``STEPS`` steps of ``Trainer.train``."""
    state = Trainer(apply_overrides(cfg, {"train.seed": seed}), patterns, work,
                    device="cpu").train(total_steps=STEPS)
    assert state.step == state.opt.count == STEPS
    return {**{f"model/{k}": v.detach().clone() for k, v in state.model.state_dict().items()},
            **{f"mu/{k}": v.clone() for k, v in state.opt.mu.items()},
            **{f"nu/{k}": v.clone() for k, v in state.opt.nu.items()}}


@pytest.fixture(scope="module")
def seed7(cfg, patterns, tmp_path_factory):
    return trained(cfg, patterns, str(tmp_path_factory.mktemp("a")), 7)


def test_same_seed_bitwise_identical(cfg, patterns, seed7, tmp_path):
    again = trained(cfg, patterns, str(tmp_path), 7)
    assert again.keys() == seed7.keys()
    for k in seed7:
        assert torch.equal(seed7[k], again[k]), k


def test_different_seed_diverges(cfg, patterns, seed7, tmp_path):
    other = trained(cfg, patterns, str(tmp_path), 8)
    assert other.keys() == seed7.keys()
    assert any(not torch.equal(seed7[k], other[k]) for k in seed7)
