#!/usr/bin/env python3
"""Export a JAX training or vocoder workdir into a workdir the PyTorch port
reads (``gst_tacotron_tpu_torch``).

A JAX ``train.py::Trainer`` workdir holds ``config.json`` and orbax
checkpoints under ``train.checkpoint_dir`` (``checkpoints/``); a JAX
``vocoder_train.py::VocoderTrainer`` workdir holds them under
``vocoder_ckpt/``. This script restores one step (the latest unless
``--step``) into the template that ``train.init_state`` (or, for a vocoder,
``vocoder.load_wavernn_variables``) builds, its shapes traced abstractly,
and writes ONE ``.npz`` beside a copy of the config:

    OUT/config.json
    OUT/checkpoints/step_<N>.npz        (a training workdir)
    OUT/vocoder_ckpt/step_<N>.npz       (a vocoder workdir, --vocoder)

with the keys

    params/<flax path>, batch_stats/<flax path>   the variables, float32, as
                                                 tests/fixtures/golden/params.npz
    opt/mu/<flax path>, opt/nu/<flax path>        Adam's moments
    opt/count, opt/schedule_count                 Adam's and the schedule's counts
                                                 (the optax chain of
                                                 train.py::make_optimizer)
    step

The port's ``CheckpointManager`` lists ``step_<N>.npz`` beside its own
``step_<N>.pt`` files, so ``OUT`` serves as ``--workdir`` of the port's
synthesize CLI and bench, as a ``--vocoder-workdir``, and as the workdir its
``Trainer`` / ``VocoderTrainer`` resume from. A training and a vocoder export
may share one ``OUT`` when they share one config: an ``OUT/config.json`` that
differs from the config being exported is refused, never replaced.

The JAX state's PRNG key is NOT exported: the port draws its dropout from
streams of its own, keyed by ``train.seed`` and the step, which no JAX key
maps onto. A resumed port run replays the JAX run's batches and optimizer
state, not its dropout masks.

Needs JAX, flax, optax and orbax (the JAX package's environment):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/export_jax_workdir.py \\
        --workdir JAX_WORKDIR --out PORT_WORKDIR [--step N]
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/export_jax_workdir.py --vocoder \\
        --workdir JAX_VOCODER_WORKDIR --config CONFIG.json --out PORT_WORKDIR
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Optional

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))


def flatten(tree: Any, prefix: str) -> Dict[str, np.ndarray]:
    """A nested mapping of arrays -> {prefix/path: float32 array}."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            flat.update(flatten(v, f"{prefix}/{k}"))
        else:
            flat[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return flat


def _template_batch(cfg) -> Dict[str, np.ndarray]:
    """A feature batch of one row: ``init_state`` reads only its widths."""
    r = cfg.model.decoder.reduction_factor
    return {"tokens": np.ones((1, 4), np.int32), "token_lengths": np.full((1,), 4, np.int32),
            "mel": np.zeros((1, 2 * r, cfg.model.num_mels), np.float32),
            "mel_lengths": np.full((1,), 2 * r, np.int32),
            "linear": np.zeros((1, 2 * r, cfg.model.num_freq), np.float32),
            "speaker_ids": np.zeros((1,), np.int32)}


def train_template(cfg):
    """The shapes and dtypes of the JAX ``TrainState`` that ``Trainer``
    restores into (``init_state``'s, traced abstractly)."""
    import jax

    from gst_tacotron_tpu.train import init_state

    return jax.eval_shape(lambda: init_state(cfg, jax.random.PRNGKey(cfg.train.seed),
                                             _template_batch(cfg))[1])


def vocoder_template(cfg):
    """The shapes and dtypes of the JAX ``TrainState`` that
    ``load_wavernn_variables`` restores into."""
    import jax
    import jax.numpy as jnp

    from gst_tacotron_tpu.models.wavernn import WaveRNN
    from gst_tacotron_tpu.train import TrainState, make_optimizer

    def state():
        model = WaveRNN(cfg.model.vocoder, cfg.model.num_mels)
        hop = cfg.model.vocoder.wavernn_hop
        variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, cfg.model.num_mels)),
                               jnp.zeros((1, 2 * hop)))
        tx = make_optimizer(cfg.optimizer)
        return TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats={}, opt_state=tx.init(variables["params"]),
                          rng=jax.random.PRNGKey(0))
    return jax.eval_shape(state)


def state_arrays(state) -> Dict[str, np.ndarray]:
    """The restored ``TrainState`` -> the export's flat keys."""
    import optax

    out = {**flatten(state.params, "params"), **flatten(state.batch_stats, "batch_stats")}
    adam = [s for s in state.opt_state if isinstance(s, optax.ScaleByAdamState)]
    sched = [s for s in state.opt_state if isinstance(s, optax.ScaleByScheduleState)]
    if len(adam) != 1 or len(sched) != 1:
        raise ValueError("the optimizer state is not train.py::make_optimizer's chain")
    out.update(flatten(adam[0].mu, "opt/mu"))
    out.update(flatten(adam[0].nu, "opt/nu"))
    out["opt/count"] = np.asarray(adam[0].count, np.int64)
    out["opt/schedule_count"] = np.asarray(sched[0].count, np.int64)
    out["step"] = np.asarray(state.step, np.int64)
    return out


def export(workdir: str, out: str, *, step: Optional[int] = None, vocoder: bool = False,
           config: Optional[str] = None) -> str:
    """Restore ``workdir``'s checkpoint at ``step`` (the latest when None)
    and write the export under ``out``; returns the ``.npz`` path."""
    from gst_tacotron_tpu.checkpoint import CheckpointManager
    from gst_tacotron_tpu.config import load_config, save_config

    cfg_path = config or os.path.join(workdir, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"no config at {cfg_path}; pass --config")
    cfg = load_config(cfg_path)
    out_cfg = os.path.join(out, "config.json")
    if os.path.exists(out_cfg) and load_config(out_cfg) != cfg:
        raise FileExistsError(f"{out_cfg} holds another config; export into another --out")
    sub = "vocoder_ckpt" if vocoder else cfg.train.checkpoint_dir
    src = os.path.join(workdir, sub)
    if not os.path.isdir(src):
        raise FileNotFoundError(f"no checkpoint directory at {src}")
    mgr = CheckpointManager(src, async_save=False)
    step = mgr.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {src}")
    state = mgr.restore(vocoder_template(cfg) if vocoder else train_template(cfg), step)
    mgr.close()
    os.makedirs(os.path.join(out, sub), exist_ok=True)
    save_config(cfg, out_cfg)
    path = os.path.join(out, sub, f"step_{int(step):08d}.npz")
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **state_arrays(state))
    os.replace(tmp, path)
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", required=True, help="the JAX training or vocoder workdir")
    p.add_argument("--out", required=True, help="the port workdir to write")
    p.add_argument("--step", type=int, help="the step to export (default: the latest)")
    p.add_argument("--vocoder", action="store_true",
                   help="a vocoder_train workdir (vocoder_ckpt/)")
    p.add_argument("--config", help="config JSON (default: WORKDIR/config.json)")
    args = p.parse_args(argv)
    print(export(args.workdir, args.out, step=args.step, vocoder=args.vocoder,
                 config=args.config))


if __name__ == "__main__":
    main()
